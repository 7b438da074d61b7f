"""Masked farthest-point sampling: kernel F (``csrc/fps.cu``) and its plain version.

Replaces ``puzzlefusion_plusplus_tpu/ops/fps.py::_fps_pallas_batched``
(``_fps_batched_kernel``); the plain version follows ``farthest_point_sample_xla``. Greedy
max-min selection from the first valid point of each cloud, ties to the lowest index,
invalid points never chosen. Bound: latency of the npoint sequential selections (see the
source note for the design).
"""

from __future__ import annotations

import torch

from puzzlefusion_plusplus_tpu_torch.ops import cuda_build

_BIG = 1e10


def farthest_point_sample_plain(
    xyz: torch.Tensor, npoint: int, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """xyz [B, N, 3], mask [B, N] bool -> idx [B, npoint] int32."""
    B, N, _ = xyz.shape
    if mask is None:
        mask = torch.ones((B, N), dtype=torch.bool, device=xyz.device)
    big = torch.tensor(_BIG, dtype=xyz.dtype, device=xyz.device)
    dist = torch.where(mask, big, -big)
    farthest = mask.to(torch.int8).argmax(1)  # first valid point (0 when none is)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    x, y, z = xyz.unbind(-1)
    for i in range(npoint):
        out[:, i] = farthest
        c = xyz[rows, farthest]  # [B, 3]
        dx, dy, dz = x - c[:, :1], y - c[:, 1:2], z - c[:, 2:3]
        d = dx * dx + dy * dy + dz * dz  # the kernel's sq_dist3 order, no FMA
        dist = torch.minimum(dist, torch.where(mask, d, -big))
        farthest = dist.argmax(1)
    return out


def farthest_point_sample(
    xyz: torch.Tensor, npoint: int, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """xyz [B, N, 3] f32, mask [B, N] bool or None -> idx [B, npoint] int32; kernel F on
    CUDA tensors."""
    if xyz.device.type == "cpu":
        return farthest_point_sample_plain(xyz, npoint, mask)
    cuda_build.require(xyz, "xyz", torch.float32, 3)
    B, N, _ = xyz.shape
    if xyz.shape[2] != 3:
        raise ValueError(f"xyz must be [B, N, 3], got {tuple(xyz.shape)}")
    mask_u8 = None
    if mask is not None:
        if mask.shape != (B, N) or mask.device != xyz.device:
            raise ValueError("mask must be [B, N] on xyz's device")
        mask_u8 = mask.to(torch.uint8).contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    lib = cuda_build.library("fps")
    cuda_build.check(
        lib.pfpp_fps(xyz.data_ptr(), None if mask_u8 is None else mask_u8.data_ptr(), B, N,
                     npoint, out.data_ptr(), cuda_build.stream_ptr(xyz)),
        "farthest_point_sample",
    )
    farthest_point_sample.launches += 1
    return out


farthest_point_sample.launches = 0
