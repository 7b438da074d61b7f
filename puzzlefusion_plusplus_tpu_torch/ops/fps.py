"""Masked farthest-point sampling: kernels F and P (``csrc/fps.cu``) and their plain version.

Greedy max-min selection from the first valid point of each cloud, ties to the lowest index,
invalid points never chosen; the plain version follows ``farthest_point_sample_xla``.
Bound: latency of the npoint sequential selections (see the source notes for the design:
points in registers, one key per candidate, one exchange per selection).

* F replaces ``puzzlefusion_plusplus_tpu/ops/fps.py::_fps_pallas_batched``
  (``_fps_batched_kernel``): one block per cloud. The encoder's stage FPS (many clouds of at
  most 1000 points) runs it.
* P replaces ``ops/fps.py::farthest_point_sample_pallas`` (``_fps_kernel``): one thread block
  cluster per cloud, each block holding a slice of it, for few clouds of many points. The
  engine's merge resample runs it. P returns F's indices.

The block and cluster shapes are chosen here (``block_shape``, ``cluster_shape``) and checked
again by the kernel's launcher, which refuses a shape it cannot run.
"""

from __future__ import annotations

import torch

from puzzlefusion_plusplus_tpu_torch.ops import cuda_build

_BIG = 1e10
P_MAX_POINTS = 8 * 12288  # kernel P: a cluster of 8 blocks of at most 12288 points
REG_TIERS = (1, 2, 4, 8, 16)  # points a thread keeps in registers
REG_MAX_THREADS = 512  # a register tier's block: at most 128 registers a thread
REG_MAX_POINTS = REG_TIERS[-1] * REG_MAX_THREADS  # beyond: the streaming variant
STREAM_THREADS = 1024
# Block shapes, from chip_smoke.py's fps_shapes timings: F is fastest with blocks of about 64
# threads and at most 8 points a thread; P, whose exchange costs more, with 16 points a thread
# and clusters whose slices hold at most 3072 points.
BLOCK_TARGET_THREADS = 64
F_MAX_POINTS_A_THREAD, P_MAX_POINTS_A_THREAD = 8, 16
P_SLICE_TARGET = 3072


def _threads(points: int, ppt: int) -> int:
    """The whole warps that hold ``points`` points at ``ppt`` a thread."""
    return max(32, (-(-points // ppt) + 31) // 32 * 32)


def launch_shapes(points: int, cluster_sizes=(1,)) -> list[tuple[int, int, int]]:
    """Every (blocks a cloud, points a thread, threads) that the kernels run for clouds of
    ``points`` points at the given cluster sizes: each register tier that fits, else the
    streaming variant. ``chip_smoke.py`` times them all."""
    out = []
    for cl in cluster_sizes:
        slice_ = -(-points // cl)
        tiers = [t for t in REG_TIERS if _threads(slice_, t) <= REG_MAX_THREADS]
        out += [(cl, t, _threads(slice_, t)) for t in tiers] or [(cl, 0, STREAM_THREADS)]
    return out


def block_shape(points: int, max_ppt: int = F_MAX_POINTS_A_THREAD) -> tuple[int, int]:
    """(points a thread, threads) of the block that holds ``points`` points: the smallest
    register tier whose block is at most ``BLOCK_TARGET_THREADS`` wide, but at most
    ``max_ppt`` unless the block would be wider than ``REG_MAX_THREADS``; (0,
    ``STREAM_THREADS``), the streaming variant, above ``REG_MAX_POINTS``."""
    if points > REG_MAX_POINTS:
        return 0, STREAM_THREADS
    ppt = next(t for t in REG_TIERS if -(-points // t) <= BLOCK_TARGET_THREADS or t == max_ppt)
    if _threads(points, ppt) > REG_MAX_THREADS:
        ppt = REG_TIERS[-1]
    return ppt, _threads(points, ppt)


def cluster_shape(points: int) -> tuple[int, int, int]:
    """Kernel P's (blocks a cloud, points a thread, threads) for clouds of ``points`` points:
    the fewest blocks (1, 2, 4 or 8) whose slices hold at most ``P_SLICE_TARGET`` points."""
    cl = next((c for c in (1, 2, 4) if -(-points // c) <= P_SLICE_TARGET), 8)
    return (cl, *block_shape(-(-points // cl), P_MAX_POINTS_A_THREAD))


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


def _launch(xyz: torch.Tensor, npoint: int, mask: torch.Tensor | None, cl: int, ppt: int,
            threads: int, per_cloud: bool) -> torch.Tensor:
    """Launch kernel P (``per_cloud``) or F at the given shape, uncounted."""
    what = "farthest_point_sample" + ("_per_cloud" if per_cloud else "")
    cuda_build.require(xyz, "xyz", torch.float32, 3)
    B, N, _ = xyz.shape
    if xyz.shape[2] != 3 or N == 0:
        raise ValueError(f"xyz must be [B, N, 3] with N > 0, got {tuple(xyz.shape)}")
    mask_u8 = None
    if mask is not None:
        if mask.shape != (B, N) or mask.device != xyz.device:
            raise ValueError("mask must be [B, N] on xyz's device")
        mask_u8 = mask.to(torch.uint8).contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    head = (xyz.data_ptr(), None if mask_u8 is None else mask_u8.data_ptr(), B, N, npoint)
    tail = (ppt, threads, out.data_ptr(), cuda_build.stream_ptr(xyz))
    if per_cloud:
        code = cuda_build.function("fps", "pfpp_fps_cluster")(*head, cl, *tail)
    else:
        code = cuda_build.function("fps", "pfpp_fps")(*head, *tail)
    cuda_build.check(code, f"{what} (blocks a cloud {cl}, points a thread {ppt}, threads "
                           f"{threads})")
    return out


def farthest_point_sample(
    xyz: torch.Tensor, npoint: int, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """xyz [B, N, 3] f32, mask [B, N] bool or None -> idx [B, npoint] int32; kernel F on
    CUDA tensors."""
    if xyz.device.type == "cpu":
        return farthest_point_sample_plain(xyz, npoint, mask)
    out = _launch(xyz, npoint, mask, 1, *block_shape(xyz.shape[1]), per_cloud=False)
    farthest_point_sample.launches += 1
    return out


farthest_point_sample.launches = 0


# P computes F's function: its plain version is F's
farthest_point_sample_per_cloud_plain = farthest_point_sample_plain


def farthest_point_sample_per_cloud(
    xyz: torch.Tensor, npoint: int, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """The same function as ``farthest_point_sample``; kernel P on CUDA tensors, which spreads
    each cloud of up to ``P_MAX_POINTS`` points over a cluster of blocks (a larger cloud
    raises); up to 8 x ``REG_MAX_POINTS`` points stay in registers."""
    if xyz.device.type == "cpu":
        return farthest_point_sample_plain(xyz, npoint, mask)
    if not 0 < xyz.shape[1] <= P_MAX_POINTS:
        raise ValueError(f"kernel P takes 1 to {P_MAX_POINTS} points a cloud, got "
                         f"{xyz.shape[1]}")
    out = _launch(xyz, npoint, mask, *cluster_shape(xyz.shape[1]), per_cloud=True)
    farthest_point_sample_per_cloud.launches += 1
    return out


farthest_point_sample_per_cloud.launches = 0
