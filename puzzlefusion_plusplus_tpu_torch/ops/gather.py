"""Exact batched point gather: kernel G (``csrc/gather.cu``) and its plain version.

Replaces ``puzzlefusion_plusplus_tpu/ops/gather_pallas.py::gather_points_pallas``
(``_gather_kernel``), which selects byte planes with one-hot matmuls only because the TPU's
matrix unit rounds f32 operands to bf16. On Hopper the gather is a load; it is bound by the
bytes it moves (see the source note).
"""

from __future__ import annotations

import torch

from puzzlefusion_plusplus_tpu_torch.ops import cuda_build


def gather_points_plain(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, ...] int -> [B, ..., C]."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(-1, -1, C))
    return out.reshape(tuple(idx.shape) + (C,))


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C] f32, idx [B, ...] int -> [B, ..., C]; kernel G on CUDA tensors.

    Indices must lie in [0, N): the kernel does not check them (that would cost a sync)."""
    if points.device.type == "cpu":
        return gather_points_plain(points, idx)
    cuda_build.require(points, "points", torch.float32, 3)
    if idx.device != points.device or idx.shape[0] != points.shape[0]:
        raise ValueError("idx must be [B, ...] on the points' device")
    B, N, C = points.shape
    flat = idx.reshape(B, -1).to(torch.int32).contiguous()
    out = torch.empty((B, flat.shape[1], C), dtype=points.dtype, device=points.device)
    lib = cuda_build.library("gather")
    cuda_build.check(
        lib.pfpp_gather(points.data_ptr(), flat.data_ptr(), out.data_ptr(), B, N,
                        flat.shape[1], C, cuda_build.stream_ptr(points)),
        "gather_points",
    )
    gather_points.launches += 1
    return out.reshape(tuple(idx.shape) + (C,))


gather_points.launches = 0
