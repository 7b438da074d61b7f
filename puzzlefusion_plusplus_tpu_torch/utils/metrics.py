"""Assembly metrics (port of ``puzzlefusion_plusplus_tpu/utils/metrics.py``).

Chamfer distances go through kernel N on CUDA tensors.
"""

from __future__ import annotations

import torch

from puzzlefusion_plusplus_tpu_torch.ops.chamfer import (
    chamfer_distance_mean,
    chamfer_distance_per_point,
)
from puzzlefusion_plusplus_tpu_torch.utils.transforms import quat_to_euler, transform_pc


def valid_mean(per_part: torch.Tensor, valids: torch.Tensor) -> torch.Tensor:
    """Masked mean over the part dim with NaN zeroing: [B, P] -> [B]."""
    per_part = torch.where(torch.isnan(per_part), torch.zeros_like(per_part), per_part)
    valids = valids.to(per_part.dtype)
    return (per_part * valids).sum(-1) / valids.sum(-1)


def _reduce(per_elem: torch.Tensor, metric: str) -> torch.Tensor:
    if metric == "mse":
        return (per_elem**2).mean(-1)
    if metric == "rmse":
        return (per_elem**2).mean(-1) ** 0.5
    if metric == "mae":
        return per_elem.abs().mean(-1)
    raise ValueError(metric)


def trans_metrics(trans1, trans2, valids, metric: str = "rmse") -> torch.Tensor:
    """[B, P, 3] x2, valids [B, P] -> [B]."""
    return valid_mean(_reduce(trans1 - trans2, metric), valids)


def rot_metrics(rot1, rot2, valids, metric: str = "rmse") -> torch.Tensor:
    """Euler-degree error with 360-degree wraparound: [B, P, 4] x2 -> [B]."""
    diff1 = (quat_to_euler(rot1) - quat_to_euler(rot2)).abs()
    return valid_mean(_reduce(torch.minimum(diff1, 360.0 - diff1), metric), valids)


def calc_part_acc(pts, trans1, trans2, rot1, rot2, valids):
    """Per-part bidirectional mean chamfer < 0.01 counts as correct.
    pts [B, P, N, 3] (world scale) -> (acc [B], acc_per_part [B, P], cd_per_part [B, P])."""
    B, P = pts.shape[:2]
    pts1 = transform_pc(trans1, rot1, pts).reshape(B * P, *pts.shape[2:])
    pts2 = transform_pc(trans2, rot2, pts).reshape(B * P, *pts.shape[2:])
    cd = chamfer_distance_mean(pts1, pts2).reshape(B, P)
    acc_per_part = (cd < 0.01) & (valids == 1)
    acc = acc_per_part.sum(-1) / (valids == 1).sum(-1)
    return acc, acc_per_part, cd


def calc_shape_cd(pts, trans1, trans2, rot1, rot2, valids) -> torch.Tensor:
    """Whole-shape chamfer with padded parts pushed to 1e3: pts [B, P, N, 3] -> [B]."""
    B, P, N, _ = pts.shape
    pts = torch.where(valids[..., None, None] == 0, torch.full_like(pts, 1e3), pts)
    pts1 = transform_pc(trans1, rot1, pts).reshape(B, P * N, 3)
    pts2 = transform_pc(trans2, rot2, pts).reshape(B, P * N, 3)
    fwd, bwd = chamfer_distance_per_point(pts1, pts2)
    return valid_mean((fwd + bwd).reshape(B, P, N).mean(-1), valids)
