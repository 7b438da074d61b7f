"""Piece-aware flat-layout ops of the matcher (port of ``puzzlefusion_plusplus_tpu/matching/
ops.py``).

All pieces of a fracture sit concatenated in one flat [B, N_sum, 3] cloud; a dense per-point
``piece_id`` [B, N_sum] (padded points get id P) is the single source of every mask.
Selections that can tie pick the lowest index, as ``lax.top_k`` and ``argmin`` do in the
JAX package (``smallest_k``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from puzzlefusion_plusplus_tpu_torch.ops.grouping import square_distance

__all__ = ["compact_critical", "critical_counts_per_piece", "diagonal_square_mask",
           "fracture_point_labels", "knn_piece_aware", "pca_canonicalize", "piece_ids",
           "same_piece_mask", "smallest_k", "square_distance", "valid_point_mask"]


def piece_ids(n_pcs: torch.Tensor, n_sum: int) -> torch.Tensor:
    """n_pcs [B, P] -> piece id per flat point [B, N_sum] int32; the padded tail gets P."""
    cumsum = torch.cumsum(n_pcs, dim=-1)
    pos = torch.arange(n_sum, device=n_pcs.device)[None, :, None]
    return (pos >= cumsum[:, None, :]).sum(-1).to(torch.int32)


def same_piece_mask(pid: torch.Tensor) -> torch.Tensor:
    """[B, N] -> [B, N, N] bool, True where two points belong to the same piece."""
    return pid[:, :, None] == pid[:, None, :]


def valid_point_mask(pid: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """[B, N] -> [B, N] bool, True for points of valid (non-padded) pieces."""
    return pid < n_valid[:, None]


def diagonal_square_mask(pid: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """True where [i, j] is a cross-piece pair of two valid points."""
    valid = valid_point_mask(pid, n_valid)
    return ~same_piece_mask(pid) & valid[:, :, None] & valid[:, None, :]


def one_hot_pieces(pid: torch.Tensor, P: int, dtype=torch.float32) -> torch.Tensor:
    """[B, N] ids -> [B, N, P] one-hot; an id >= P (padding) gives a zero row, as
    ``jax.nn.one_hot`` does."""
    return F.one_hot(pid.long().clamp(0, P), P + 1)[..., :P].to(dtype)


def smallest_k(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries of the last axis, ascending, ties to the lower index (the
    order of ``lax.top_k(-d, k)``) -> (values, int64 indices)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def pca_canonicalize(pts: torch.Tensor, pid: torch.Tensor, valid: torch.Tensor,
                     max_parts: int) -> torch.Tensor:
    """Every piece rotated into its sign-disambiguated PCA frame (principal axis first; the
    first two signs by positive third moments, the third by r3 = r1 x r2); padded points
    map to 0. pts [B, N, 3], pid/valid [B, N] -> [B, N, 3]."""
    dt = pts.dtype
    w = one_hot_pieces(pid, max_parts, dt) * valid[..., None].to(dt)  # [B, N, P]
    cnt = w.sum(1).clamp_min(1.0)
    mean = torch.einsum("bnp,bnc->bpc", w, pts) / cnt[..., None]
    cent = (pts - torch.einsum("bnp,bpc->bnc", w, mean)) * valid[..., None].to(dt)
    cov = torch.einsum("bnp,bnc,bnd->bpcd", w, cent, cent) / cnt[..., None, None]
    _, evecs = torch.linalg.eigh(cov)  # ascending eigenvalues
    e = evecs.flip(-1)  # principal axis first; columns e[..., :, k]
    proj = torch.einsum("bnc,bncd->bnd", cent, torch.einsum("bnp,bpcd->bncd", w, e))
    skew = torch.einsum("bnp,bnd->bpd", w, proj**3)
    s = torch.where(skew >= 0, 1.0, -1.0).to(dt)
    r1 = e[..., :, 0] * s[..., 0][..., None]
    r2 = e[..., :, 1] * s[..., 1][..., None]
    basis = torch.stack([r1, r2, torch.linalg.cross(r1, r2, dim=-1)], dim=-1)
    return torch.einsum("bnc,bncd->bnd", cent, torch.einsum("bnp,bpcd->bncd", w, basis))


def knn_piece_aware(xyz: torch.Tensor, pid: torch.Tensor, k: int,
                    cross_piece: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN within the same piece (or across pieces with ``cross_piece``), nearest first.
    xyz [B, N, 3], pid [B, N] -> (sqdist [B, N, k], idx [B, N, k] int64)."""
    d = square_distance(xyz, xyz)
    same = same_piece_mask(pid)
    allowed = ~same if cross_piece else same
    return smallest_k(torch.where(allowed, d, 1e10), k)


def fracture_point_labels(gt_pcs: torch.Tensor, pid: torch.Tensor, n_valid: torch.Tensor,
                          thresholds: torch.Tensor) -> torch.Tensor:
    """GT fracture-point labels [B, N] int32: the distance to the nearest point of another
    valid piece is below the point's threshold."""
    d = torch.sqrt(square_distance(gt_pcs, gt_pcs).clamp_min(0.0))
    d = torch.where(diagonal_square_mask(pid, n_valid), d, 1e6)
    labels = (d.amin(-1) < thresholds) & valid_point_mask(pid, n_valid)
    return labels.to(torch.int32)


def compact_critical(labels: torch.Tensor, *arrays: torch.Tensor):
    """Critical (label 1) points sorted to the front, order kept (a stable sort).
    -> (slot_valid [B, N] bool, the arrays gathered in that order, order [B, N] int64)."""
    order = torch.argsort(1 - labels, dim=-1, stable=True)
    n_crit = labels.sum(-1, keepdim=True)
    slot_valid = torch.arange(labels.shape[-1], device=labels.device)[None, :] < n_crit
    gathered = tuple(
        torch.take_along_dim(a, order.reshape(order.shape + (1,) * (a.dim() - 2)), dim=1)
        for a in arrays)
    return slot_valid, gathered, order


def critical_counts_per_piece(labels: torch.Tensor, pid: torch.Tensor, P: int) -> torch.Tensor:
    """n_critical_pcs [B, P]: critical points per piece."""
    return (labels[..., None] * one_hot_pieces(pid, P, labels.dtype)).sum(1)
