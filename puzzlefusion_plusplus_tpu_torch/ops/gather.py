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
on CPU tensors. Where no gradient can flow (grad mode off, or points that need none, as in
the engine and the frozen encoder) the gathers launch without ``autograd.Function``.

G and A take float32 or bfloat16 points (the frozen encoder's composable encode under
``trainer.precision=bf16`` gathers bf16 features): the kernel copies bytes, so bf16 rows go
through the same kernel on 16-byte or 2-byte units, never upcast. B takes float32 only.

The wrappers choose G's unit width (``gather_width``) and B's route (``scatter_fused``),
both pure functions tested on the CPU; ``_launch_gather`` and ``_launch_scatter_add`` are
the bare launches on buffers made beforehand, which ``chip_smoke.py`` times apart from the
call path.
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


GATHER_MAX_ROW_UNITS = 8192  # kernel G divides by a row's units with a 32-bit reciprocal
SCATTER_MAX_N = 58112  # kernel B counts a cloud's n keys in 227 KB of shared memory
SCATTER_FUSED_FLOATS = 8192  # a cloud's g up to this size takes kernel B's one-launch route


GATHER_DTYPES = (torch.float32, torch.bfloat16)


def gather_width(C: int, points_ptr: int, elem_bytes: int = 4) -> int:
    """Values a unit of kernel G moves: a 16-byte unit (4 floats, or 8 bf16 values) when a row
    is whole units and the source is 16-byte aligned (outputs come from ``torch.empty``,
    which aligns them), else 1 (a view at an odd storage offset takes the scalar path)."""
    per_unit = 16 // elem_bytes
    return per_unit if C % per_unit == 0 and points_ptr % 16 == 0 else 1


def _flat_idx(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if idx.device != points.device or idx.shape[0] != points.shape[0]:
        raise ValueError("idx must be [B, ...] on the points' device")
    return idx.reshape(idx.shape[0], -1).to(torch.int32).contiguous()


def _launch_gather(points: torch.Tensor, flat: torch.Tensor, out: torch.Tensor) -> None:
    """Kernel G's bare launch: points [B, N, C] f32 or bf16, flat [B, R] int32, out
    [B, R, C] of the points' dtype, all contiguous on the card (checked by the caller)."""
    B, N, C = points.shape
    width = gather_width(C, points.data_ptr(), points.element_size())
    if C // width > GATHER_MAX_ROW_UNITS:
        raise ValueError(f"kernel G takes rows of at most {GATHER_MAX_ROW_UNITS} units, "
                         f"got C = {C}")
    fn = "pfpp_gather" if points.dtype == torch.float32 else "pfpp_gather_bf16"
    cuda_build.check(
        cuda_build.function("gather", fn)(
            points.data_ptr(), flat.data_ptr(), out.data_ptr(), B, N, flat.shape[1], C,
            width > 1, cuda_build.stream_ptr(points)),
        "gather_points",
    )


def _gather_forward(points: torch.Tensor, idx: torch.Tensor, approx: bool) -> torch.Tensor:
    """The plain gather on CPU tensors; kernel G on CUDA tensors, counted as G's or, with
    ``approx``, as A's launch."""
    if points.device.type == "cpu":
        return gather_points_plain(points, idx)
    flat = _flat_idx(points, idx)
    if points.dtype not in GATHER_DTYPES:
        raise TypeError(f"points must be float32 or bfloat16, got {points.dtype}")
    cuda_build.require(points, "points", points.dtype, 3)
    B, N, C = points.shape
    out = torch.empty((B, flat.shape[1], C), dtype=points.dtype, device=points.device)
    _launch_gather(points, flat, out)
    (gather_points_approx if approx else gather_points).launches += 1
    return out.reshape(tuple(idx.shape) + (C,))


def _launch_scatter_add(g: torch.Tensor, flat: torch.Tensor, out: torch.Tensor,
                        scratch: torch.Tensor | None) -> None:
    """Kernel B's bare launch: g [B, R, C] f32, flat [B, R] int32, out [B, n, C]; scratch
    None for the fused route (one launch), else ``scatter_scratch_ints`` int32 (two)."""
    B, R, C = g.shape
    cuda_build.check(
        cuda_build.function("scatter_add", "pfpp_scatter_add")(
            g.data_ptr(), flat.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, out.shape[1], R, C,
            cuda_build.stream_ptr(g)),
        "scatter_add",
    )


def scatter_fused(R: int, C: int, n: int) -> bool:
    """Kernel B's route: one launch when a cloud's g is small (R * C <= 8192 floats) and
    one warp's n counts fit shared memory beside two copies of it and a counter; else two
    launches through scratch (``csrc/scatter_add.cu`` sizes the same way)."""
    return R * C <= SCATTER_FUSED_FLOATS and n + 2 * R * C + 1 <= SCATTER_MAX_N


def scatter_scratch_ints(B: int, R: int, n: int, C: int) -> int:
    """Kernel B's scratch: none on the fused route, else each cloud's CSR lists (R ints)
    and row pointers (n + 1)."""
    return 0 if scatter_fused(R, C, n) else B * (R + n + 1)


def scatter_add(g: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """g [B, R, C] f32, idx [B, R] int in [0, n) -> dpoints [B, n, C]; kernel B on CUDA
    tensors, deterministic and equal to the rows added in order. The kernel counts a cloud's
    n keys in shared memory, so n <= 58112. Indices are not checked (that would cost a
    sync)."""
    if g.device.type == "cpu":
        return scatter_add_plain(g, idx, n)
    g = g.contiguous()
    cuda_build.require(g, "g", torch.float32, 3)
    B, R, C = g.shape
    if idx.shape != (B, R) or idx.device != g.device:
        raise ValueError(f"idx must be [{B}, {R}] on g's device, got {tuple(idx.shape)}")
    if n > SCATTER_MAX_N:
        raise ValueError(f"kernel B counts n keys in shared memory: n = {n} is above "
                         f"{SCATTER_MAX_N}")
    flat = idx.to(torch.int32).contiguous()
    out = torch.empty((B, n, C), dtype=torch.float32, device=g.device)
    ints = scatter_scratch_ints(B, R, n, C)
    scratch = torch.empty(ints, dtype=torch.int32, device=g.device) if ints else None
    _launch_scatter_add(g, flat, out, scratch)
    scatter_add.launches += 1
    return out


scatter_add.launches = 0


class _GatherFn(torch.autograd.Function):
    """out = points[b, idx[b, ...]]; backward scatter-adds into points, no gradient for idx.
    ``approx`` picks the launch count it adds to: kernel A's rather than G's."""

    @staticmethod
    def forward(ctx, points, idx, approx):
        ctx.n = points.shape[1]
        ctx.save_for_backward(idx)
        return _gather_forward(points, idx, approx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        B, C = grad.shape[0], grad.shape[-1]
        return scatter_add(grad.reshape(B, -1, C), idx.reshape(B, -1), ctx.n), None, None


def _gather(points: torch.Tensor, idx: torch.Tensor, approx: bool) -> torch.Tensor:
    # autograd's bookkeeping only where a gradient can flow (the engine's gathers skip it)
    if torch.is_grad_enabled() and points.requires_grad:
        return _GatherFn.apply(points, idx, approx)
    return _gather_forward(points, idx, approx)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C] f32 or bf16, idx [B, ...] int -> [B, ..., C]; kernel G on CUDA tensors,
    differentiable in ``points`` (kernel B). Indices must lie in [0, N): the kernel does not
    check them (that would cost a sync)."""
    return _gather(points, idx, False)


gather_points.launches = 0


def gather_points_approx(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel A: the gather of grouped features that feed a Dense layer. Exact on Hopper
    (see the module note); same arguments as ``gather_points``."""
    return _gather(points, idx, True)


gather_points_approx.launches = 0
