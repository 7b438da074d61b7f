"""Fixed-shape part compaction (port of ``puzzlefusion_plusplus_tpu/utils/masking.py``).

Valid parts are permuted to the front and the tail slots are filled with cyclic repeats of
the valid parts, so every encoder slot carries real data; ``scatter_parts`` is the inverse.
"""

from __future__ import annotations

import torch


def compaction_indices(valids: torch.Tensor):
    """valids [B, P] {0,1} -> (order [B, P], src [B, P], slot_valid [B, P] bool).

    ``order`` puts valid parts first (stable); ``src[b, s] = order[b, s % n_valid]``;
    ``slot_valid[b, s] = s < n_valid``."""
    P = valids.shape[-1]
    v = valids.to(torch.int64)
    order = torch.argsort(1 - v, dim=-1, stable=True)
    n_valid = v.sum(-1, keepdim=True)
    n = n_valid.clamp_min(1)
    slots = torch.arange(P, device=valids.device)[None, :]
    src = torch.gather(order, 1, slots % n)
    slot_valid = (slots < n) & (n_valid > 0)
    return order, src, slot_valid


def _expand_index(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(idx.shape + x.shape[2:])


def compact_parts(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """x [B, P, ...], src [B, P] -> [B, P, ...] gathered by slot source index."""
    return torch.gather(x, 1, _expand_index(src, x))


def scatter_parts(x: torch.Tensor, order: torch.Tensor, slot_valid: torch.Tensor):
    """Slot-major [B, P, ...] -> part-major: slot s lands at part order[b, s]; invalid slots
    write zeros. ``order`` is a permutation, so the scatter has no duplicate targets."""
    mask = slot_valid.reshape(slot_valid.shape + (1,) * (x.dim() - 2))
    masked = torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))
    return torch.zeros_like(x).scatter(1, _expand_index(order, x), masked)
