#!/bin/bash
# Jigsaw matcher training (reference Jigsaw_matching experiments: 250 epochs, bs 1, cosine 1e-3).
# One card unless num_devices=N is passed on.
python -m puzzlefusion_plusplus_tpu_torch.matching.train \
    data_dir=pc_data/everyday/train epochs=250 batch_size=1 "$@"
