#!/bin/bash
# Stage-3 verifier training (reference scripts/train_verifier.sh: single device, batch 64).
python -m puzzlefusion_plusplus_tpu_torch.training.verifier \
    data.verifier_data_path=verifier_data/everyday \
    data.batch_size=64 \
    verifier.epochs=100 \
    trainer.experiment_name=everyday "$@"
