"""Part-count shape bucketing: serve each batch at the smallest part pad that fits it.

A copy of ``puzzlefusion_plusplus_tpu/data/bucketing.py`` (numpy only), kept so that the port
imports nothing from the JAX package, and the steps the port's callers share.

The engine (inference/engine.py) derives every static shape from its input arrays and the
model parameters are part-count independent (the denoiser slices its sinusoidal table to P,
models/denoiser.py; the verifier attends over however many edges it is given). XLA therefore
specializes the compiled program per (B, P) pad. All part-indexed arrays are padded tail-wise
with parts stored valid-first (datasets.py::_pad) and match edges stored valid-first
(datasets.py::_densify_matching), so a batch whose shapes all have ``num_parts <= P_b`` can be
SLICED down to pad ``P_b`` with zero semantic change — validity masks already make every
compute stage padding-invariant (property-tested in tests/test_bucketing.py, which relies on
the padding-invariant per-part rng streams in inference/engine.py).

Why it pays on TPU: denoiser token count is ``P*L`` (linear work in P, attention quadratic),
the frozen-encoder row count is ``B*P`` clouds, the verifier edge count is ``P(P-1)/2``, and
the merge chain is ``[P, P, N]`` — serving a <=12-part batch at P=12 instead of the global
P=20 pad cuts well over a third of all engine FLOPs. This is the TPU-native equivalent of
sequence-length bucketing in production transformer serving; the reference has no analogue
(it is locked to batch 1 at a fixed 20-part zero-pad, reference denoiser/dataset/dataset.py
:210-217 and docs/test.md:8).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from puzzlefusion_plusplus_tpu_torch.data.loader import Loader

# keys with a part axis right after the batch axis: [B, P, ...]
PART_KEYS = (
    "part_pcs", "part_trans", "part_rots", "part_scale", "part_valids", "ref_part",
    "part_pcs_gt", "area_pts", "n_area",
)
# [B, P, P]
SQUARE_KEYS = ("graph",)
# [B, E, ...] densified match edges, valid-first; edges are stored DIRECTED (both
# orientations per adjacent pair, matching/generate.py:137), so a P-part pad holds at most
# P(P-1) of them (the dataset default max_edges_dense=380 is exactly 20*19)
EDGE_KEYS = ("match_edges", "match_edge_valid", "corr_src", "corr_tgt", "corr_count")


def edge_budget(P_b: int) -> int:
    """Max densified directed match edges for a part pad of ``P_b``."""
    return P_b * (P_b - 1)


def part_bucket(max_parts: int, multiple: int = 4, cap: int = 20) -> int:
    """Smallest multiple of ``multiple`` >= max_parts, clamped to [multiple, cap].

    A handful of buckets keeps the number of distinct XLA specializations (one compile each)
    small while recovering most of the padding waste.
    """
    if max_parts > cap:
        raise ValueError(f"max_parts {max_parts} exceeds bucket cap {cap}")
    b = -(-int(max_parts) // multiple) * multiple
    return max(multiple, min(b, cap))


def slice_batch_parts(batch: dict, P_b: int) -> dict:
    """Slice every part-indexed array in a stacked batch down to part pad ``P_b``.

    Requires ``num_parts <= P_b`` for every sample and no valid match edge beyond the
    bucket's edge budget ``P_b(P_b-1)`` (both asserted). Non-array and non-part keys pass
    through untouched. Works on numpy or jax arrays (pure slicing).
    """
    num_parts = np.asarray(batch["num_parts"])
    if int(num_parts.max()) > P_b:
        raise ValueError(f"bucket P={P_b} smaller than max num_parts {int(num_parts.max())}")
    E_b = edge_budget(P_b)
    if "match_edge_valid" in batch:
        ev = np.asarray(batch["match_edge_valid"])
        if ev.shape[-1] > E_b and ev[..., E_b:].any():
            raise ValueError("valid match edges beyond the bucket edge budget")
    out = dict(batch)
    for k in PART_KEYS:
        if k in out and getattr(out[k], "ndim", 0) >= 2 and out[k].shape[1] > P_b:
            out[k] = out[k][:, :P_b]
    for k in SQUARE_KEYS:
        if k in out and getattr(out[k], "ndim", 0) >= 3:
            out[k] = out[k][:, :P_b, :P_b]
    for k in EDGE_KEYS:
        if k in out and out[k].shape[1] > E_b:
            out[k] = out[k][:, :E_b]
    return out


def bucket_keys(ds, multiple: int, cap: int = 20) -> list[int] | None:
    """The part bucket of each shape of ``ds``, a ``Loader``'s ``bucket_key`` (its batches
    never mix buckets); None without bucketing (``multiple`` 0)."""
    if not multiple:
        return None
    return [part_bucket(int(c), multiple, cap=cap) for c in ds.num_parts_list()]


def slice_to_bucket(batch: dict, multiple: int, cap: int = 20) -> dict:
    """``batch`` sliced to the bucket of its largest shape; unchanged without bucketing
    (``multiple`` 0)."""
    if not multiple:
        return batch
    return slice_batch_parts(batch, part_bucket(int(np.max(batch["num_parts"])), multiple,
                                                cap=cap))


def bucketed_loaders(train_ds, val_ds, data, seed: int, rows: Callable[[dict, bool], dict]):
    """A trainer's (train loader, val loader, prepare) under ``data.part_bucket_multiple``:
    ``prepare(batch, pad=False)`` slices a global batch to its bucket's pad (so every rank
    runs the same shapes) before ``rows(batch, pad)`` takes this rank's rows."""
    mult, cap = data.part_bucket_multiple, data.max_num_part

    def prepare(batch: dict, pad: bool = False) -> dict:
        return rows(slice_to_bucket(batch, mult, cap), pad)

    return (Loader(train_ds, data.batch_size, seed=seed,
                   bucket_key=bucket_keys(train_ds, mult, cap)),
            Loader(val_ds, data.val_batch_size, shuffle=False, drop_last=False, seed=seed,
                   bucket_key=bucket_keys(val_ds, mult, cap)),
            prepare)
