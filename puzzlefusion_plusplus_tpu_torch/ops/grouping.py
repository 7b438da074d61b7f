"""Point grouping ops (port of ``puzzlefusion_plusplus_tpu/ops/grouping.py``).

``index_points`` goes through kernel G and ``index_points_matmul_safe`` through kernel A on
CUDA tensors; both are differentiable in the points (kernel B). Ball-query selection and kNN
are plain PyTorch: the JAX package also runs them outside Pallas.
"""

from __future__ import annotations

import torch

from puzzlefusion_plusplus_tpu_torch.ops.gather import gather_points, gather_points_approx


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Expanded-form pairwise squared L2, as the JAX package computes it.
    src [B, N, C], dst [B, M, C] -> [B, N, M]."""
    d = -2.0 * torch.einsum("bnc,bmc->bnm", src, dst)
    d = d + (src**2).sum(-1)[..., :, None]
    return d + (dst**2).sum(-1)[..., None, :]


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, ...] -> [B, ..., C] (exact gather)."""
    return gather_points(points, idx)


def index_points_matmul_safe(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather of values that feed a Dense layer (grouped features): kernel A, exact."""
    return gather_points_approx(points, idx)


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """xyz [B, N, 3], new_xyz [B, S, 3] -> group idx [B, S, nsample] int32.

    Keeps the ``nsample`` lowest-index points within ``radius``; slots past the hit count
    repeat the first hit; a query with no hit at all gets index 0."""
    N = xyz.shape[1]
    in_ball = square_distance(new_xyz, xyz) <= radius**2
    if valid is not None:
        in_ball = in_ball & valid[:, None, :]
    ar = torch.arange(N, dtype=torch.int32, device=xyz.device)
    cand = torch.where(in_ball, ar, torch.full_like(ar, N))
    group_idx = torch.topk(cand, nsample, dim=-1, largest=False, sorted=True).values
    first = group_idx[..., :1].expand_as(group_idx)
    group_idx = torch.where(group_idx == N, first, group_idx)
    return torch.where(group_idx == N, torch.zeros_like(group_idx), group_idx)


def knn_points(query: torch.Tensor, points: torch.Tensor, k: int,
               valid: torch.Tensor | None = None):
    """query [B, S, 3], points [B, N, 3] -> (sqdist, idx int64) [B, S, k], nearest first.
    Equal distances may come in another order than ``lax.top_k`` gives them."""
    sqd = square_distance(query, points)
    if valid is not None:
        sqd = torch.where(valid[:, None, :], sqd, torch.full_like(sqd, 1e10))
    return torch.topk(sqd, k, dim=-1, largest=False, sorted=True)
