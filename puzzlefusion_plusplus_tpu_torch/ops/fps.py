"""Masked farthest-point sampling: kernels F and P (``csrc/fps.cu``) and their plain version.

Greedy max-min selection from the first valid point of each cloud, ties to the lowest index,
invalid points never chosen; the plain version follows ``farthest_point_sample_xla``.
Bound: latency of the npoint sequential selections (see the source notes for the designs).

* F replaces ``puzzlefusion_plusplus_tpu/ops/fps.py::_fps_pallas_batched``
  (``_fps_batched_kernel``): one block per cloud, coordinates read from L2. The encoder's
  stage FPS (many clouds of at most 1000 points) runs it.
* P replaces ``ops/fps.py::farthest_point_sample_pallas`` (``_fps_kernel``): one thread block
  cluster per cloud with the whole cloud resident in the blocks' shared memory, for few
  clouds of many points. The engine's merge resample runs it. P returns F's indices.
"""

from __future__ import annotations

import torch

from puzzlefusion_plusplus_tpu_torch.ops import cuda_build

_BIG = 1e10
P_MAX_POINTS = 8 * 12288  # kernel P: 8 blocks of at most 12288 resident points


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


def _launch(fn_name: str, what: str, xyz: torch.Tensor, npoint: int,
            mask: torch.Tensor | None) -> torch.Tensor:
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
        getattr(lib, fn_name)(xyz.data_ptr(), None if mask_u8 is None else mask_u8.data_ptr(),
                              B, N, npoint, out.data_ptr(), cuda_build.stream_ptr(xyz)),
        what,
    )
    return out


def farthest_point_sample(
    xyz: torch.Tensor, npoint: int, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """xyz [B, N, 3] f32, mask [B, N] bool or None -> idx [B, npoint] int32; kernel F on
    CUDA tensors."""
    if xyz.device.type == "cpu":
        return farthest_point_sample_plain(xyz, npoint, mask)
    out = _launch("pfpp_fps", "farthest_point_sample", xyz, npoint, mask)
    farthest_point_sample.launches += 1
    return out


farthest_point_sample.launches = 0


# P computes F's function: its plain version is F's
farthest_point_sample_per_cloud_plain = farthest_point_sample_plain


def farthest_point_sample_per_cloud(
    xyz: torch.Tensor, npoint: int, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """The same function as ``farthest_point_sample``; kernel P on CUDA tensors, which keeps
    each cloud of up to ``P_MAX_POINTS`` points resident on chip (a larger cloud raises)."""
    if xyz.device.type == "cpu":
        return farthest_point_sample_plain(xyz, npoint, mask)
    if not 0 < xyz.shape[1] <= P_MAX_POINTS:
        raise ValueError(f"kernel P takes 1 to {P_MAX_POINTS} points a cloud, got "
                         f"{xyz.shape[1]}")
    out = _launch("pfpp_fps_cluster", "farthest_point_sample_per_cloud", xyz, npoint, mask)
    farthest_point_sample_per_cloud.launches += 1
    return out


farthest_point_sample_per_cloud.launches = 0
