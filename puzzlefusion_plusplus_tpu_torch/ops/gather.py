"""Batched point gathers and their scatter-add backward: kernels G and A (``csrc/gather.cu``),
kernel B (``csrc/scatter_add.cu``) and their plain versions.

G replaces ``puzzlefusion_plusplus_tpu/ops/gather_pallas.py::gather_points_pallas``
(``_gather_kernel``), which selects byte planes with one-hot matmuls only because the TPU's
matrix unit rounds f32 operands to bf16. On Hopper the gather is a load; it is bound by the
bytes it moves (see the source note).

A replaces ``gather_pallas.py::gather_points_approx`` (``_gather_approx_kernel``), whose one
f32 matmul returns values the TPU rounded to bf16. That rounding comes from the TPU's matrix
unit alone, and the JAX package's own CPU path for this call is the exact gather
(``ops/grouping.py::index_points_matmul_safe``), so on Hopper A is G's kernel, exact, under
its own launch counter.

B replaces ``gather_pallas.py::_gather_bwd_pallas`` (``_scatter_add_kernel``): the gradient
of both gathers, and of the chamfer loss for its target cloud. ``_GatherFn`` runs the same
forward and backward code on both devices: the kernels on CUDA tensors, the plain versions
on CPU tensors.
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


def scatter_add_plain(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """g [B, R, C], idx [B, R] int in [0, n) -> dpoints [B, n, C], rows added in order."""
    B, R, C = g.shape
    rows = (idx.long() + n * torch.arange(B, device=idx.device)[:, None]).reshape(-1)
    out = torch.zeros((B * n, C), dtype=g.dtype, device=g.device)
    return out.index_add_(0, rows, g.reshape(B * R, C)).reshape(B, n, C)


def _flat_idx(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if idx.device != points.device or idx.shape[0] != points.shape[0]:
        raise ValueError("idx must be [B, ...] on the points' device")
    return idx.reshape(idx.shape[0], -1).to(torch.int32).contiguous()


def _gather_kernel(points: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Launch G's kernel: points [B, N, C] f32 CUDA, flat [B, R] int32 -> [B, R, C]."""
    cuda_build.require(points, "points", torch.float32, 3)
    B, N, C = points.shape
    out = torch.empty((B, flat.shape[1], C), dtype=points.dtype, device=points.device)
    cuda_build.check(
        cuda_build.library("gather").pfpp_gather(
            points.data_ptr(), flat.data_ptr(), out.data_ptr(), B, N, flat.shape[1], C,
            cuda_build.stream_ptr(points)),
        "gather_points",
    )
    return out


def scatter_add(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """g [B, R, C] f32, idx [B, R] int in [0, n) -> dpoints [B, n, C]; kernel B on CUDA
    tensors. The kernel keeps a cloud's [n, tile] sum in shared memory, so n * 4 bytes must
    fit 227 KB (n <= 58112). Indices are not checked (that would cost a sync)."""
    if g.device.type == "cpu":
        return scatter_add_plain(g, idx, n)
    g = g.contiguous()
    cuda_build.require(g, "g", torch.float32, 3)
    B, R, C = g.shape
    if idx.shape != (B, R) or idx.device != g.device:
        raise ValueError(f"idx must be [{B}, {R}] on g's device, got {tuple(idx.shape)}")
    lib = cuda_build.library("scatter_add")
    if lib.pfpp_scatter_add_tile(n, C) == 0:
        raise ValueError(f"kernel B holds [n, 1] f32 in shared memory: n = {n} is too large")
    flat = idx.to(torch.int32).contiguous()
    out = torch.empty((B, n, C), dtype=torch.float32, device=g.device)
    cuda_build.check(
        lib.pfpp_scatter_add(g.data_ptr(), flat.data_ptr(), out.data_ptr(), B, n, R, C,
                             cuda_build.stream_ptr(g)),
        "scatter_add",
    )
    scatter_add.launches += 1
    return out


scatter_add.launches = 0


class _GatherFn(torch.autograd.Function):
    """out = points[b, idx[b, ...]]; backward scatter-adds into points, no gradient for idx.
    ``approx`` picks the launch count it adds to: kernel A's rather than G's."""

    @staticmethod
    def forward(ctx, points, idx, approx):
        ctx.n = points.shape[1]
        if points.device.type == "cpu":
            ctx.save_for_backward(idx)
            return gather_points_plain(points, idx)
        flat = _flat_idx(points, idx)
        out = _gather_kernel(points, flat)
        (gather_points_approx if approx else gather_points).launches += 1
        ctx.save_for_backward(flat)
        return out.reshape(tuple(idx.shape) + (points.shape[2],))

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        B, C = grad.shape[0], grad.shape[-1]
        return scatter_add(grad.reshape(B, -1, C), idx.reshape(B, -1), ctx.n), None, None


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C] f32, idx [B, ...] int -> [B, ..., C]; kernel G on CUDA tensors,
    differentiable in ``points`` (kernel B). Indices must lie in [0, N): the kernel does not
    check them (that would cost a sync)."""
    return _GatherFn.apply(points, idx, False)


gather_points.launches = 0


def gather_points_approx(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel A: the gather of grouped features that feed a Dense layer. Exact on Hopper
    (see the module note); same arguments as ``gather_points``."""
    return _GatherFn.apply(points, idx, True)


gather_points_approx.launches = 0
