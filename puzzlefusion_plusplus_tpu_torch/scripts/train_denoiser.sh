#!/bin/bash
# Stage-2 denoiser training (reference scripts/train_denoiser.sh: 4-GPU DDP, batch 64/device).
# Every local card (trainer.num_devices=-1); data.batch_size is the GLOBAL batch.
python -m puzzlefusion_plusplus_tpu_torch.training.denoiser \
    data.data_dir=pc_data/everyday/train \
    data.data_val_dir=pc_data/everyday/val \
    data.batch_size=256 \
    denoiser.epochs=2000 \
    denoiser.encoder_ckpt_path=output/everyday/vqvae/ckpt/latest \
    trainer.experiment_name=everyday "$@"
