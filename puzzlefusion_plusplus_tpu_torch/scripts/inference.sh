#!/bin/bash
# Full auto-agglomerative inference (reference scripts/inference.sh: bs=1 single GPU; here
# shapes batch on the card -- inference.batch_size is the shapes of one engine call).
python -m puzzlefusion_plusplus_tpu_torch.inference.run \
    data.data_val_dir=pc_data/everyday/val \
    data.matching_data_path=matching_data/everyday \
    denoiser.ckpt_path=output/everyday/denoiser/ckpt/latest \
    denoiser.encoder_ckpt_path=output/everyday/vqvae/ckpt/latest \
    verifier.ckpt_path=output/everyday/verifier/ckpt/latest \
    inference.batch_size=8 \
    trainer.experiment_name=everyday "$@"
