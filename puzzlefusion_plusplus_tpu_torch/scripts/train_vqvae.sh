#!/bin/bash
# Stage-1 VQ-VAE training (reference scripts/train_vqvae.sh: 4-GPU DDP, per-device batch 45).
# Data parallelism spans every local card (trainer.num_devices=-1, the default): one process
# a card over NCCL; data.batch_size is the GLOBAL batch. Run from the repository's root.
python -m puzzlefusion_plusplus_tpu_torch.training.vqvae \
    data.data_dir=pc_data/everyday/train \
    data.data_val_dir=pc_data/everyday/val \
    data.batch_size=180 \
    ae.epochs=2000 \
    trainer.experiment_name=everyday "$@"
