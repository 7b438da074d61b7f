"""Nearest-neighbour / chamfer distances: kernels N and M (``csrc/nn.cu``) and their plain
versions.

N replaces ``puzzlefusion_plusplus_tpu/ops/chamfer_pallas.py::nn_distance_pallas``
(``_nn_kernel``) and feeds the metrics; M replaces ``chamfer_pallas.py::masked_pairwise_nn``
(``_masked_pair_nn_kernel``) and feeds the merge step's interpenetration filter. Both compute
squared distances from direct FP32 differences; they are bound by FP32 operations (see the
source note). Only the forward exists in this slice.
"""

from __future__ import annotations

import torch

from puzzlefusion_plusplus_tpu_torch.ops import cuda_build

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


def nn_distance(x: torch.Tensor, y: torch.Tensor):
    """Squared distance to, and index of, each x-point's nearest neighbour in y; kernel N on
    CUDA tensors. x [B, N, 3] f32, y [B, M, 3] f32 -> ([B, N] f32, [B, N] int32)."""
    if x.device.type == "cpu":
        return nn_distance_plain(x, y)
    cuda_build.require(x, "x", torch.float32, 3)
    cuda_build.require(y, "y", torch.float32, 3)
    B, N, _ = x.shape
    if y.shape[0] != B or x.shape[2] != 3 or y.shape[2] != 3 or y.device != x.device:
        raise ValueError(f"bad shapes {tuple(x.shape)} / {tuple(y.shape)}")
    dist = torch.empty((B, N), dtype=torch.float32, device=x.device)
    idx = torch.empty((B, N), dtype=torch.int32, device=x.device)
    lib = cuda_build.library("nn")
    cuda_build.check(
        lib.pfpp_nn_distance(x.data_ptr(), y.data_ptr(), B, N, y.shape[1], dist.data_ptr(),
                             idx.data_ptr(), cuda_build.stream_ptr(x)),
        "nn_distance",
    )
    nn_distance.launches += 1
    return dist, idx


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
    3.9e12; kernel M on CUDA tensors (inactive pairs skip their compute, with no host sync).
    pts [B, P, N, 3] f32, pair_mask [B, P, P] bool -> [B, P, P, N] f32."""
    if pts.device.type == "cpu":
        return masked_pairwise_nn_plain(pts, pair_mask)
    cuda_build.require(pts, "pts", torch.float32, 4)
    B, P, N, _ = pts.shape
    if pair_mask.shape != (B, P, P) or pair_mask.device != pts.device:
        raise ValueError("pair_mask must be [B, P, P] on pts' device")
    mask = pair_mask.to(torch.uint8).contiguous()
    out = torch.empty((B, P, P, N), dtype=torch.float32, device=pts.device)
    lib = cuda_build.library("nn")
    cuda_build.check(
        lib.pfpp_masked_pairwise_nn(pts.data_ptr(), mask.data_ptr(), B, P, N, out.data_ptr(),
                                    cuda_build.stream_ptr(pts)),
        "masked_pairwise_nn",
    )
    masked_pairwise_nn.launches += 1
    return out


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
