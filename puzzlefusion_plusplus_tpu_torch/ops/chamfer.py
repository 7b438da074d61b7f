"""Nearest-neighbour / chamfer distances: kernels N and M (``csrc/nn.cu``) and their plain
versions.

N replaces ``puzzlefusion_plusplus_tpu/ops/chamfer_pallas.py::nn_distance_pallas``
(``_nn_kernel``) and feeds the metrics; M replaces ``chamfer_pallas.py::masked_pairwise_nn``
(``_masked_pair_nn_kernel``) and feeds the merge step's interpenetration filter. Both compute
squared distances from direct FP32 differences, bit-equal to the plain versions; they are
bound by instruction issue (see the source note, which also gives their launch shapes).
``nn_distance`` is differentiable through ``_NNDistanceFn``, the port of the custom VJP of
``puzzlefusion_plusplus_tpu/ops/chamfer.py::nn_distance``: the query side gets
``2 (x - y[idx]) g``, the target side the scatter-add of its negative (kernel B).
"""

from __future__ import annotations

import torch

from puzzlefusion_plusplus_tpu_torch.ops import cuda_build
from puzzlefusion_plusplus_tpu_torch.ops.gather import gather_points, scatter_add

INACTIVE = 3.9e12  # masked_pairwise_nn's value for pairs outside the mask
_CHUNK_ELEMS = 1 << 25  # query chunk size of the plain version, in distance-matrix entries


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., 3], b [..., 3] broadcast -> (dx*dx + dy*dy) + dz*dz, the kernels' order."""
    diff = a - b
    return diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]


def nn_distance_plain(x: torch.Tensor, y: torch.Tensor):
    """x [B, N, 3], y [B, M, 3] -> (sqdist [B, N] f32, idx [B, N] int32), queries chunked so
    the [chunk, M] distance block stays bounded (an unchunked [8, 20000, 20000] is 12.8 GB)."""
    B, N, _ = x.shape
    M = y.shape[1]
    chunk = max(1, _CHUNK_ELEMS // max(1, B * M))
    dists, idxs = [], []
    for n0 in range(0, N, chunk):
        d = _sq_dist(x[:, n0 : n0 + chunk, None, :], y[:, None, :, :])
        dmin, imin = d.min(-1)  # first minimal index on ties
        dists.append(dmin)
        idxs.append(imin.to(torch.int32))
    return torch.cat(dists, 1), torch.cat(idxs, 1)


def _launch_nn(x: torch.Tensor, y: torch.Tensor, dist: torch.Tensor, idx: torch.Tensor) -> None:
    """Launch kernel N into ``dist``/``idx``, uncounted."""
    B, N, _ = x.shape
    code = cuda_build.function("nn", "pfpp_nn_distance")(
        x.data_ptr(), y.data_ptr(), B, N, y.shape[1], dist.data_ptr(), idx.data_ptr(),
        cuda_build.stream_ptr(x))
    cuda_build.check(code, "nn_distance")


def _nn_distance_forward(x: torch.Tensor, y: torch.Tensor):
    if x.device.type == "cpu":
        return nn_distance_plain(x, y)
    cuda_build.require(x, "x", torch.float32, 3)
    cuda_build.require(y, "y", torch.float32, 3)
    B, N, _ = x.shape
    if y.shape[0] != B or x.shape[2] != 3 or y.shape[2] != 3 or y.device != x.device:
        raise ValueError(f"bad shapes {tuple(x.shape)} / {tuple(y.shape)}")
    dist = torch.empty((B, N), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, N), dtype=torch.int32, device=x.device)
    _launch_nn(x, y, dist, idx)
    nn_distance.launches += 1
    return dist, idx


class _NNDistanceFn(torch.autograd.Function):
    """Forward N; no gradient flows through the index. The target side's scatter-add is
    skipped when y needs no gradient (the loss's input cloud)."""

    @staticmethod
    def forward(ctx, x, y):
        dist, idx = _nn_distance_forward(x, y)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(x, y, idx)
        return dist, idx

    @staticmethod
    def backward(ctx, gd, _gidx):
        x, y, idx = ctx.saved_tensors
        diff = 2.0 * (x - gather_points(y, idx)) * gd[..., None]
        dy = scatter_add(-diff, idx, y.shape[1]) if ctx.needs_input_grad[1] else None
        return diff if ctx.needs_input_grad[0] else None, dy


def nn_distance(x: torch.Tensor, y: torch.Tensor):
    """Squared distance to, and index of, each x-point's nearest neighbour in y; kernel N on
    CUDA tensors, differentiable in x and y. x [B, N, 3] f32, y [B, M, 3] f32 ->
    ([B, N] f32, [B, N] int32)."""
    return _NNDistanceFn.apply(x, y)


nn_distance.launches = 0


def masked_pairwise_nn_plain(pts: torch.Tensor, pair_mask: torch.Tensor) -> torch.Tensor:
    """pts [B, P, N, 3], pair_mask [B, P, P] bool -> [B, P, P, N]."""
    B, P, N, _ = pts.shape
    out = torch.full((B, P, P, N), INACTIVE, dtype=pts.dtype, device=pts.device)
    for b, i, j in pair_mask.nonzero().tolist():
        out[b, i, j] = nn_distance_plain(pts[b, i][None], pts[b, j][None])[0][0]
    return out


def masked_pairwise_nn(pts: torch.Tensor, pair_mask: torch.Tensor) -> torch.Tensor:
    """out[b, i, j, n] = min_m |pts[b, i, n] - pts[b, j, m]|^2 where pair_mask[b, i, j], else
    3.9e12; kernel M on CUDA tensors (inactive pairs skip their compute, with no host sync;
    no backward: it raises where autograd would need one).
    pts [B, P, N, 3] f32, pair_mask [B, P, P] bool -> [B, P, P, N] f32."""
    if pts.device.type == "cpu":
        return masked_pairwise_nn_plain(pts, pair_mask)
    cuda_build.forbid_grad("masked_pairwise_nn", pts)
    cuda_build.require(pts, "pts", torch.float32, 4)
    B, P, N, _ = pts.shape
    if pair_mask.shape != (B, P, P) or pair_mask.device != pts.device:
        raise ValueError("pair_mask must be [B, P, P] on pts' device")
    if pair_mask.dtype != torch.bool:
        pair_mask = pair_mask != 0
    out = torch.empty((B, P, P, N), dtype=torch.float32, device=pts.device)
    _launch_masked(pts, pair_mask.contiguous(), out)
    masked_pairwise_nn.launches += 1
    return out


def _launch_masked(pts: torch.Tensor, mask: torch.Tensor, out: torch.Tensor) -> None:
    """Launch kernel M into ``out``, uncounted; the kernel reads the contiguous bool mask's
    own bytes (0 or 1)."""
    B, P, N, _ = pts.shape
    code = cuda_build.function("nn", "pfpp_masked_pairwise_nn")(
        pts.data_ptr(), mask.data_ptr(), B, P, N, out.data_ptr(), cuda_build.stream_ptr(pts))
    cuda_build.check(code, "masked_pairwise_nn")


masked_pairwise_nn.launches = 0


def chamfer_distance_per_point(x: torch.Tensor, y: torch.Tensor):
    """Per-point squared NN distances both ways -> (fwd [B, N], bwd [B, M])."""
    return nn_distance(x, y)[0], nn_distance(y, x)[0]


def chamfer_distance_mean(x: torch.Tensor, y: torch.Tensor, bidirectional: bool = True):
    """chamferdist(point_reduction='mean') -> [B]."""
    out = nn_distance(x, y)[0].mean(-1)
    if bidirectional:
        out = out + nn_distance(y, x)[0].mean(-1)
    return out


def chamfer_distance_default(x: torch.Tensor, y: torch.Tensor, bidirectional: bool = True):
    """chamferdist's default reductions (per-cloud point sum, batch mean) -> scalar; the
    reduction of the VQ-VAE training loss."""
    out = nn_distance(x, y)[0].sum(-1)
    if bidirectional:
        out = out + nn_distance(y, x)[0].sum(-1)
    return out.mean()
