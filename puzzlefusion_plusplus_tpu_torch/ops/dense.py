"""Kernel D (``csrc/dense.cu``): the denoiser's inference linears, y = x @ W^T + b, in 3xTF32
on the tensor cores, and its plain version.

It replaces no TPU kernel (the JAX denoiser's Dense layers go to XLA). With TF32 off, cuBLAS
runs the fp32 products on the CUDA cores; D runs them on the tensor cores at FP32 accuracy:
each operand x is split into big = tf32(x) and small = x - big (the rule of
``sa_fused.tf32_planes``), and a product is big*big + big*small + small*big accumulated in
FP32, within about 1e-6 of FP32 where one TF32 pass misses the engine's 1e-4 gate. Bound:
those three TF32 MMAs a product at 495 TFLOP/s.

The weights arrive split: ``weight_planes`` lays W^T out as ``tf32_planes`` does, its inputs
permuted within each run of 16 so that the kernel loads a lane's A fragments as float4s of x,
and (``geglu``) its output columns interleaved 8 by 8, h with the matching gate columns, so
that the epilogue writes h * gelu(gate). ``SplitWeights`` holds the planes of one or more
``nn.Linear`` layers and rebuilds them in place (the denoiser's attention, GEGLU and
feed-forward, ``models/denoiser.py``, whose model decides when). ``tile_shape`` picks the block
shape and the split of K from (M, N, K).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from puzzlefusion_plusplus_tpu_torch.ops import cuda_build
from puzzlefusion_plusplus_tpu_torch.ops.sa_fused import tf32_join, tf32_planes

SMS = 132  # the H100's streaming multiprocessors
# blocks a wave at one block an SM where a split of K puts 4 blocks in a cluster: the card
# holds at most 30 such clusters at once (its GPCs' layout; 128 such blocks took two waves
# in chip_smoke.py's dense_shapes sweep, 96 took one)
CLUSTER4_SLOTS = 120
# (block rows, block columns) -> blocks an SM (the kernel's block shapes)
BLOCK_SHAPES = {(128, 128): 1, (128, 64): 1, (64, 64): 2}
# (block rows, block columns, split of K) -> (us a wave, us a ring stage of 32 inputs for each
# block on the busiest SM): a launch took about waves x the first plus the second x the stages
# that its busiest SM runs (least squares over the denoiser's linears at M = 100-4000 in two
# sweeps, every choice within 15% of the sweep's fastest shape; NVIDIA H100 80GB HBM3, 700 W,
# chip_smoke.py's dense_shapes phase)
WAVE_COST = {(128, 128, 1): (4.98, 1.23), (128, 128, 2): (7.54, 1.27),
             (128, 128, 4): (8.89, 1.35), (128, 64, 1): (2.5, 0.75),
             (128, 64, 2): (4.57, 0.75), (128, 64, 4): (5.84, 0.75),
             (64, 64, 1): (4.18, 0.4), (64, 64, 2): (5.08, 0.43), (64, 64, 4): (4.74, 0.44)}
KT = 32  # inputs a stage of the kernel's weight ring


@functools.lru_cache(maxsize=None)
def _k_order(K: int) -> torch.Tensor:
    """The planes' input order: position 16c + 8s + j (k8 slice s of the run c of 16, its
    logical input j) holds input 16c + 4 (j % 4) + 2s + j // 4, the order in which a lane's
    float4 of x feeds the two slices' A fragments (``csrc/dense.cu``)."""
    c = torch.arange(K // 16)[:, None, None, None]  # positions [c, s, j // 4, j % 4]
    s, jh, jl = torch.arange(2)[:, None, None], torch.arange(2)[:, None], torch.arange(4)
    return (16 * c + 4 * jl + 2 * s + jh).reshape(K)


@functools.lru_cache(maxsize=None)
def _geglu_cols(N: int) -> torch.Tensor:
    """The GEGLU planes' column order: position 16i + t holds h's column 8i + t and 16i + 8 + t
    gate's, N / 2 + 8i + t."""
    i = torch.arange(N // 16)[:, None, None]
    return (8 * i + torch.arange(2)[:, None] * (N // 2) + torch.arange(8)).reshape(N)


def weight_planes(w: torch.Tensor, geglu: bool = False) -> torch.Tensor:
    """w [N, K] f32 (an ``nn.Linear``'s weight; K % 16 == 0, N % 16 == 0) -> D's planes
    [K/8, 2, N/8, 2, 8, 4]: ``tf32_planes`` of W^T with its inputs in ``_k_order`` and, with
    ``geglu``, its columns in ``_geglu_cols``."""
    N, K = w.shape
    wt = w.t()
    if geglu:
        wt = wt[:, _geglu_cols(N).to(w.device)]
    return tf32_planes(wt[_k_order(K).to(w.device)].contiguous())


def weight_join(planes: torch.Tensor, geglu: bool = False) -> torch.Tensor:
    """The weight [N, K] of ``weight_planes``' output, bit for bit."""
    wt_perm = tf32_join(planes)
    K, N = wt_perm.shape
    wt = torch.empty_like(wt_perm)
    wt[_k_order(K).to(wt.device)] = wt_perm
    if geglu:
        cols = torch.empty_like(wt)
        cols[:, _geglu_cols(N).to(wt.device)] = wt
        wt = cols
    return wt.t()


def bias_order(b: torch.Tensor, geglu: bool = False) -> torch.Tensor:
    """A bias [N] in the planes' column order."""
    return b[_geglu_cols(b.shape[0]).to(b.device)] if geglu else b


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x f32 -> (big, small): big rounds x to TF32 as ``split_tf32`` in
    ``csrc/sa_common.cuh`` does, small = x - big, exactly."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    big = (bits + 0x1000) & 0xFFFFE000
    big = torch.where(big >= 1 << 31, big - (1 << 32), big).to(torch.int32).view(torch.float32)
    return big, x - big


def split_linear_plain(x: torch.Tensor, planes: torch.Tensor, bias: torch.Tensor | None = None,
                       geglu: bool = False) -> torch.Tensor:
    """The plain version of D: x [..., K] -> [..., N] (with ``geglu`` [..., N / 2]), the three
    split products big*big + big*small + small*big in FP32, then the bias (in the planes'
    column order) and, with ``geglu``, h * gelu(gate)."""
    K, N = 8 * planes.shape[0], 8 * planes.shape[2]
    p = planes.permute(1, 0, 3, 5, 2, 4).reshape(2, K, N)  # the planes in _k_order
    xb, xs = _split(x[..., _k_order(K).to(x.device)])
    y = xb @ p[0] + xb @ p[1] + xs @ p[0]
    if bias is not None:
        y = y + bias
    if not geglu:
        return y
    y = y.reshape(*y.shape[:-1], N // 16, 2, 8)
    return (y[..., 0, :] * F.gelu(y[..., 1, :])).reshape(*y.shape[:-3], N // 2)


@functools.lru_cache(maxsize=None)
def tile_shape(M: int, N: int, K: int) -> tuple[int, int, int]:
    """(block rows, block columns, split of K) for D at these sizes: the least estimated time
    in ``WAVE_COST``. The blocks spread over the SMs (``CLUSTER4_SLOTS`` of them with a split
    of 4); the busiest SM runs ``load`` of them, ``BLOCK_SHAPES`` at a time."""
    best = None
    for (bm, bn, split), (per_wave, per_stage) in WAVE_COST.items():
        if N % bn or K % (split * KT):
            continue
        blocks = -(-M // bm) * (N // bn) * split
        load = -(-blocks // (CLUSTER4_SLOTS if split == 4 else SMS))
        waves = -(-load // BLOCK_SHAPES[bm, bn])
        cost = waves * per_wave + load * per_stage * K // (split * KT)
        if best is None or cost < best[0]:
            best = (cost, (bm, bn, split))
    if best is None:
        raise ValueError(f"kernel D takes N % 64 == 0 and K % 32 == 0, got N={N}, K={K}")
    return best[1]


def split_linear(x: torch.Tensor, planes: torch.Tensor, bias: torch.Tensor | None = None,
                 geglu: bool = False) -> torch.Tensor:
    """x [..., K] f32 @ W^T + bias -> [..., N] (with ``geglu`` h * gelu(gate), [..., N / 2]),
    W given as ``weight_planes`` and bias in their column order (``bias_order``). CPU tensors
    run ``split_linear_plain``; CUDA tensors launch kernel D (``csrc/dense.cu``), which has no
    backward."""
    K, N = 8 * planes.shape[0], 8 * planes.shape[2]
    if x.device.type == "cpu":
        return split_linear_plain(x, planes, bias, geglu)
    cuda_build.forbid_grad("split_linear", x, planes, bias)
    if x.shape[-1] != K or (geglu and bias is None):
        raise ValueError(f"split_linear: x {tuple(x.shape)} against planes of K={K}, N={N}"
                         f"{' (geglu needs a bias)' if geglu else ''}")
    x2 = x.reshape(-1, K).contiguous()
    cuda_build.require(x2, "x", torch.float32, 2, align16=True)
    cuda_build.require(planes, "planes", torch.float32, 6, align16=True)
    if bias is not None:
        cuda_build.require(bias, "bias", torch.float32, 1)
    out = _launch(x2, planes, bias, geglu, *tile_shape(x2.shape[0], N, K))
    split_linear.launches += 1
    return out.reshape(*x.shape[:-1], out.shape[-1])


def _launch(x2, planes, bias, geglu, bm, bn, split) -> torch.Tensor:
    """One launch of D on checked operands at block shape (bm, bn) and a split of K."""
    K, N = x2.shape[1], 8 * planes.shape[2]
    out = torch.empty((x2.shape[0], N // 2 if geglu else N), dtype=torch.float32,
                      device=x2.device)
    cuda_build.check(
        cuda_build.function("dense", "pfpp_dense")(
            x2.data_ptr(), planes.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), x2.shape[0], N, K, int(geglu), bm, bn, split,
            cuda_build.stream_ptr(x2)),
        "split_linear",
    )
    return out


split_linear.launches = 0


class SplitWeights:
    """D's planes of one or more ``nn.Linear`` layers (their weights stacked along the output)
    and their bias. ``build`` writes into the same tensors where their shape and device allow,
    so that a captured CUDA graph that reads them sees the new values at its next replay; the
    owner decides when a source changed (``DenoiserTransformer._refresh_split``). Plain
    attributes, never parameters or buffers: ``state_dict()`` leaves them out."""

    def __init__(self, layers, geglu: bool = False):
        self.layers, self.geglu = tuple(layers), geglu
        self.planes: torch.Tensor | None = None
        self.bias: torch.Tensor | None = None

    def sources(self) -> list:
        """The layers' weights and biases, as they are now."""
        return [t for lin in self.layers for t in (lin.weight, lin.bias) if t is not None]

    def build(self) -> None:
        """The planes and bias from the layers' weights, never inside a CUDA graph's capture.
        Built as ordinary tensors, outside inference mode, so that a later rebuild may write
        into them in place under ``no_grad`` too."""
        with torch.inference_mode(False), torch.no_grad():
            w = torch.cat([lin.weight for lin in self.layers])
            planes = weight_planes(w.detach().float(), self.geglu)
            biases = [lin.bias for lin in self.layers]
            bias = (None if any(b is None for b in biases)
                    else bias_order(torch.cat(biases).detach().float(), self.geglu))
            self.planes = _into(self.planes, planes)
            self.bias = None if bias is None else _into(self.bias, bias)

    def drop(self) -> None:
        self.planes = self.bias = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """D's product of x with the planes as last built."""
        return split_linear(x, self.planes, self.bias, self.geglu)


def _into(old: torch.Tensor | None, new: torch.Tensor) -> torch.Tensor:
    """new, written into old where old has its shape, dtype and device."""
    if (old is None or old.shape != new.shape or old.device != new.device
            or old.dtype != new.dtype):
        return new
    return old.copy_(new)
