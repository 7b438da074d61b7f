"""The overfit-gap probe (port of ``scripts/eval_train_split.py``): the best denoiser
checkpoint's full-sampling metrics on a subset of its own TRAINING shapes, through the
validation pipeline (val-mode dataset, bucketed batches, ``make_sample_fn`` and
``eval_metrics``).

The gap between these and the logged ``eval_part_acc`` on held-out shapes separates "the
model cannot fit this data" (both low) from "the model memorises N_TRAIN shapes and N_TRAIN
is too small" (train high, held-out low).

``N_TRAIN=512 SUBSET=32 BATCH=16 SPLIT=train BUCKET_MULT=4 python -m
puzzlefusion_plusplus_tpu_torch.scripts.eval_train_split [--cpu]`` reads the checkpoints of
``synthetic_train_eval``'s run root ``<tmp>/pfpp_torch_gen_<N_TRAIN>``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.data.bucketing import bucket_keys, slice_to_bucket
from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset
from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device
from puzzlefusion_plusplus_tpu_torch.models.scheduler import DDPMParams
from puzzlefusion_plusplus_tpu_torch.scripts import (
    Clock,
    cli_device,
    env_int,
    run_root,
    stage_dir,
)
from puzzlefusion_plusplus_tpu_torch.scripts.evidence import collect, write_summary
from puzzlefusion_plusplus_tpu_torch.scripts.synthetic_train_eval import gen_config
from puzzlefusion_plusplus_tpu_torch.training import denoiser as tden
from puzzlefusion_plusplus_tpu_torch.training.state import best_checkpoint, load_checkpoint
from puzzlefusion_plusplus_tpu_torch.training.vqvae import to_device
from puzzlefusion_plusplus_tpu_torch.utils.config import Config


def make_sampler(cfg: Config, ckpt: str, device):
    """The validation sampler with the denoiser of checkpoint ``ckpt`` and the frozen
    encoder of ``denoiser.encoder_ckpt_path``."""
    model = tden.make_model(cfg)
    model.load_state_dict(load_checkpoint(ckpt)["model"])
    return tden.make_sample_fn(model.to(device), tden.load_frozen_encoder(cfg, device),
                               DDPMParams.piecewise(cfg.denoiser.ddpm_train_steps),
                               cfg.denoiser.num_inference_steps)


def val_loader(ds: DenoiserDataset, batch: int, bucket_mult: int, max_num_part: int) -> Loader:
    """The validation loader over ``ds``: in order, batches within one part bucket."""
    return Loader(ds, batch, shuffle=False, drop_last=False, seed=0,
                  bucket_key=bucket_keys(ds, bucket_mult, max_num_part))


def batch_metrics(sample_fn, loader: Loader, bucket_mult: int, max_num_part: int,
                  generator: torch.Generator, device) -> list[dict]:
    """The sampler's mean metrics of each batch, each sliced to its bucket's part pad; the
    noise comes from ``generator`` in batch order."""
    out = []
    for batch in loader:
        b = to_device(slice_to_bucket(batch, bucket_mult, max_num_part), device)
        final, _ = sample_fn(b, generator)
        out.append({k: float(v.float().mean()) for k, v in tden.eval_metrics(final, b).items()})
    return out


def run(cfg: Config, root: str, n_train: int = 512, subset: int = 32, batch: int = 16,
        split: str = "train", bucket_mult: int = 4, device=None,
        evidence_dir: str | None = None) -> dict:
    """Sampling metrics of the best denoiser checkpoint of ``root`` on ``subset`` shapes of
    ``split`` -> the summary it writes."""
    device = resolve_device(device)
    clock = Clock()
    cfg = gen_config(root, cfg, bucket_mult)
    ckpt_dir = stage_dir(cfg, "denoiser") + "/ckpt"
    best = best_checkpoint(ckpt_dir)
    if best is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    clock.say(f"best ckpt: {best}")
    sample_fn = make_sampler(cfg, best, device)
    # val-mode semantics over the split's files: the in-training validation's transforms
    ds = DenoiserDataset(root + f"/pc_data/{split}", mode="val",
                         max_num_part=cfg.data.max_num_part,
                         multiple_ref_parts=cfg.denoiser.multiple_ref_parts, overfit=subset)
    accs = batch_metrics(sample_fn, val_loader(ds, batch, bucket_mult, cfg.data.max_num_part),
                         bucket_mult, cfg.data.max_num_part,
                         torch.Generator(device=device).manual_seed(7), device)
    agg = {k: float(np.mean([a[k] for a in accs])) for k in accs[0]}
    clock.say(f"{split}-split ({subset} shapes) metrics: {agg}")
    eng_dir = cfg.trainer.output_dir + "/engine_eval"
    os.makedirs(eng_dir, exist_ok=True)
    summary = {"metrics": agg, "n_train": n_train, "subset": subset, "split": split,
               "best_ckpt": best, "per_batch": accs}
    write_summary(eng_dir, f"{split}split_sampling", summary)
    collect(eng_dir, f"gen{n_train}/engine", evidence_dir=evidence_dir)
    return summary


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = cli_device(argv)
    n_train = env_int("N_TRAIN", 512)
    return run(Config(), run_root(f"gen_{n_train}"), n_train=n_train,
               subset=env_int("SUBSET", 32), batch=env_int("BATCH", 16),
               split=os.environ.get("SPLIT", "train"), bucket_mult=env_int("BUCKET_MULT", 4),
               device=device)


if __name__ == "__main__":
    main()
