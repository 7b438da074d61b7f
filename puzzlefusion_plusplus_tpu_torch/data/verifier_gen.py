"""Verifier training data from a trained denoiser (port of
``puzzlefusion_plusplus_tpu/data/verifier_gen.py``).

For each training shape and round:
  1. draw final poses from the denoiser's 20-step reverse diffusion (an injected
     ``sample_fn``, e.g. ``training/denoiser.py::make_sample_fn``; kernels S, F, G);
  2. pose the matching data's area clouds at those poses and take the per-edge matched
     correspondence CD histograms over the upper triangle of the part pad, as the engine
     does (``inference/engine.py::edge_histograms``);
  3. label an edge positive when both its parts are well posed: each part's bidirectional
     chamfer to its ground-truth pose below ``part_acc_threshold`` (kernel N).

The features run on the device; only the labels and the files go through numpy. The files
have the verifier schema (``cls_gt``, ``edge_features [E, 6]``, ``edge_indices [E, 2]``).
``denoiser_sample_fn`` builds the sampler from the checkpoints that a config names.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset
from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
from puzzlefusion_plusplus_tpu_torch.inference.engine import edge_histograms, triu_indices
from puzzlefusion_plusplus_tpu_torch.inference.run import make_models, resolve_device
from puzzlefusion_plusplus_tpu_torch.inference.sampler import make_frozen_encoder
from puzzlefusion_plusplus_tpu_torch.models.scheduler import DDPMParams
from puzzlefusion_plusplus_tpu_torch.ops.chamfer import chamfer_distance_mean
from puzzlefusion_plusplus_tpu_torch.training.denoiser import make_sample_fn
from puzzlefusion_plusplus_tpu_torch.training.vqvae import to_device
from puzzlefusion_plusplus_tpu_torch.utils.config import Config
from puzzlefusion_plusplus_tpu_torch.utils.transforms import quat_apply_raw, transform_pc

MATCHING_KEYS = ("match_edges", "match_edge_valid", "corr_src", "corr_tgt", "corr_count")


def shape_features(batch: dict, final: torch.Tensor, triu: torch.Tensor, P: int):
    """One shape's (batch of 1) per-part chamfer to its GT pose [P] and edge histograms of
    the upper-triangle pairs [P(P-1)/2, 6] at the final poses [1, P, 7]."""
    f = final[0]
    pts = batch["part_pcs"][0] * batch["part_scale"][0][..., None]
    posed = transform_pc(f[:, :3], f[:, 3:], pts)
    gt_posed = transform_pc(batch["part_trans"][0], batch["part_rots"][0], pts)
    cd = chamfer_distance_mean(posed, gt_posed, bidirectional=True)
    area_world = quat_apply_raw(f[:, None, 3:], batch["area_pts"][0]) + f[:, None, :3]
    grid = edge_histograms(area_world[None], *(batch[k] for k in MATCHING_KEYS), P)[0]
    return cd, grid[triu[:, 0], triu[:, 1]]


def generate_verifier_data(
    sample_fn,  # (batch of tensors, generator) -> (final [B, P, 7], trajectory)
    pc_data_dir: str,
    matching_data_path: str,
    out_dir: str,
    max_num_part: int = 20,
    part_acc_threshold: float = 0.01,
    max_samples: int | None = None,
    seed: int = 0,
    rounds: int = 1,
    device=None,
) -> int:
    """Write one verifier .npz per (shape, round), ``{data_id:05d}_{round}.npz``; the poses
    are drawn with a ``torch.Generator`` seeded from ``seed``. Returns the files written.
    Runs on ``cuda`` unless ``device="cpu"``."""
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    ds = DenoiserDataset(pc_data_dir, mode="test", matching_data_path=matching_data_path,
                         max_num_part=max_num_part)
    loader = Loader(ds, 1, shuffle=False, drop_last=False, seed=seed)
    triu = triu_indices(max_num_part, device)
    triu_np = triu.cpu().numpy()
    generator = torch.Generator(device=device).manual_seed(seed)
    written = 0
    for bi, batch in enumerate(loader):
        if max_samples is not None and bi >= max_samples:
            break
        tensors = to_device(batch, device)
        num_parts = int(batch["num_parts"][0])
        keep = (triu_np[:, 0] < num_parts) & (triu_np[:, 1] < num_parts)
        edge_idx = triu_np[keep]
        for r in range(rounds):
            final, _ = sample_fn(tensors, generator)
            cd, feats = shape_features(tensors, final, triu, max_num_part)
            correct = (cd.cpu().numpy() < part_acc_threshold) & (batch["part_valids"][0] > 0)
            np.savez(
                os.path.join(out_dir, f"{int(batch['data_id'][0]):05d}_{r}.npz"),
                cls_gt=(correct[edge_idx[:, 0]] & correct[edge_idx[:, 1]]).astype(np.int64),
                edge_features=feats.cpu().numpy()[keep].astype(np.float32),
                edge_indices=edge_idx.astype(np.int64),
            )
            written += 1
    return written


def denoiser_sample_fn(cfg: Config, device):
    """The denoiser's sampler (``make_sample_fn``) with the weights of ``make_models``: the
    checkpoints that ``denoiser.ckpt_path`` and ``denoiser.encoder_ckpt_path`` name, seeded
    where a key is empty."""
    vqvae, denoiser, _ = make_models(cfg)
    return make_sample_fn(denoiser.to(device), make_frozen_encoder(vqvae.to(device)),
                          DDPMParams.piecewise(cfg.denoiser.ddpm_train_steps),
                          cfg.denoiser.num_inference_steps)
