"""Piece-aware pointwise encoders of the matcher (port of ``puzzlefusion_plusplus_tpu/
matching/encoder.py``): ``PointNet2MSGPointwise`` (4 multi-scale SA stages and 4 FP stages,
the reference channel plan) and ``DGCNN`` (kNN edge convolutions).

Clouds stay flat, [B, N_sum, 3] with a per-point piece id. Sampling is masked FPS over the
whole flat cloud (kernel F on the card, ``ops/fps.py``); every neighbourhood query pushes
cross-piece pairs 1e6 away. Every float gather goes through ``ops/grouping.py::index_points``
(kernel G, its backward kernel B); the piece ids and validity flags are gathered with
``torch.gather``. Each 1x1 conv is an ``nn.Linear`` on channel-last activations and each
BatchNorm is ``models/vqvae.py::MaskedBatchNorm`` (flax's: biased variance, running
statistics ``0.9 old + 0.1 batch``, statistics over every point, padding included).
The max over a neighbourhood is ``amax``, whose gradient splits evenly over tied entries
as ``jnp.max``'s does (the ball query repeats its first hit).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from puzzlefusion_plusplus_tpu_torch.matching.ops import knn_piece_aware, smallest_k
from puzzlefusion_plusplus_tpu_torch.models.vqvae import MaskedBatchNorm
from puzzlefusion_plusplus_tpu_torch.ops.fps import farthest_point_sample
from puzzlefusion_plusplus_tpu_torch.ops.grouping import index_points, square_distance

_BIG = 1e6
# (radii, nsamples, mlps) of sa1..sa4 (the reference pointnet2_msg.py:8-45)
SA_PLAN = (
    ((0.05, 0.1), (16, 32), ((16, 16, 32), (32, 32, 64))),
    ((0.1, 0.2), (16, 32), ((64, 64, 128), (64, 96, 128))),
    ((0.2, 0.4), (16, 32), ((128, 196, 256), (128, 196, 256))),
    ((0.4, 0.8), (16, 32), ((256, 256, 512), (256, 384, 512))),
)
FP_PLAN = {"fp4": (256, 256), "fp3": (256, 256), "fp2": (256, 128), "fp1": (128, 128, 128)}


def piece_aware_sqdist(src, dst, src_pid, dst_pid):
    """Squared distances with cross-piece pairs pushed ``_BIG`` away."""
    return square_distance(src, dst) + torch.where(
        src_pid[:, :, None] == dst_pid[:, None, :], 0.0, _BIG)


def ball_group(radius, nsample, xyz, new_xyz, pid, new_pid, feats):
    """Piece-aware radius grouping, recentred: the ``nsample`` lowest-index points of the
    ball, slots past the hit count repeating the first hit (index 0 with no hit)."""
    N = xyz.shape[1]
    nsample = min(nsample, N)
    in_ball = piece_aware_sqdist(new_xyz, xyz, new_pid, pid) <= radius**2
    ar = torch.arange(N, dtype=torch.int32, device=xyz.device)
    cand = torch.where(in_ball, ar, N)
    idx = torch.topk(cand, nsample, dim=-1, largest=False, sorted=True).values
    idx = torch.where(idx == N, idx[..., :1], idx)
    idx = torch.where(idx == N, 0, idx)
    grouped_xyz = index_points(xyz, idx) - new_xyz[:, :, None, :]
    if feats is None:
        return grouped_xyz
    return torch.cat([grouped_xyz, index_points(feats, idx)], dim=-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N] gathered along the points by idx [B, S]."""
    return torch.gather(x, 1, idx.long())


class SetAbstractionMsg(nn.Module):
    """FPS to ``npoint`` centres, then per radius: ball grouping, Linear-BN-ReLU layers and
    the max over the neighbourhood; the radii's features concatenated."""

    def __init__(self, cin: int, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]]):
        super().__init__()
        self.npoint, self.radii, self.nsamples = npoint, tuple(radii), tuple(nsamples)
        self.depths = tuple(len(m) for m in mlps)
        for r_i, mlp in enumerate(mlps):
            c = cin + 3
            for j, ch in enumerate(mlp):
                setattr(self, f"conv{r_i}_{j}", nn.Linear(c, ch))
                setattr(self, f"bn{r_i}_{j}", MaskedBatchNorm(ch))
                c = ch

    def forward(self, xyz, pid, feats, valid):
        """xyz [B, N, 3], pid/valid [B, N], feats [B, N, D] or None ->
        (new_xyz [B, S, 3], new_pid [B, S], new_feats [B, S, C], new_valid [B, S])."""
        fps_idx = farthest_point_sample(xyz, self.npoint, mask=valid)
        new_xyz = index_points(xyz, fps_idx)
        new_pid, new_valid = _take(pid, fps_idx), _take(valid, fps_idx)
        outs = []
        for r_i, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            g = ball_group(radius, nsample, xyz, new_xyz, pid, new_pid, feats)
            for j in range(self.depths[r_i]):
                g = getattr(self, f"conv{r_i}_{j}")(g)
                g = torch.relu(getattr(self, f"bn{r_i}_{j}")(g))
            outs.append(g.amax(dim=2))
        return new_xyz, new_pid, torch.cat(outs, dim=-1), new_valid


class FeaturePropagation(nn.Module):
    """Inverse-distance 3-NN interpolation (piece-aware) from level 2 up to level 1, then
    Linear-BN-ReLU layers."""

    def __init__(self, cin: int, mlp: Sequence[int]):
        super().__init__()
        self.depth = len(mlp)
        for j, ch in enumerate(mlp):
            setattr(self, f"conv{j}", nn.Linear(cin, ch))
            setattr(self, f"bn{j}", MaskedBatchNorm(ch))
            cin = ch

    def forward(self, xyz1, xyz2, pid1, pid2, feats1, feats2):
        dists, idx = smallest_k(piece_aware_sqdist(xyz1, xyz2, pid1, pid2), 3)
        w = 1.0 / dists.clamp_min(1e-10)
        w = w / w.sum(-1, keepdim=True)
        interp = (index_points(feats2, idx) * w[..., None]).sum(dim=2)
        h = interp if feats1 is None else torch.cat([feats1, interp], dim=-1)
        for j in range(self.depth):
            h = torch.relu(getattr(self, f"bn{j}")(getattr(self, f"conv{j}")(h)))
        return h


class PointNet2MSGPointwise(nn.Module):
    """4-SA / 4-FP per-point encoder: xyz [B, N, 3] -> features [B, N, feat_out]."""

    def __init__(self, feat_out: int = 128, npoints: Sequence[int] = (1024, 256, 64, 16)):
        super().__init__()
        cin, widths = 3, []
        for i, (radii, nsamples, mlps) in enumerate(SA_PLAN):
            setattr(self, f"sa{i + 1}", SetAbstractionMsg(cin, npoints[i], radii, nsamples,
                                                          mlps))
            cin = sum(m[-1] for m in mlps)
            widths.append(cin)
        # fp4 joins l3 and l4, fp3 l2 and fp4's output, fp2 l1 and fp3's, fp1 fp2's alone
        cins = {"fp4": widths[2] + widths[3], "fp3": widths[1] + FP_PLAN["fp4"][-1],
                "fp2": widths[0] + FP_PLAN["fp3"][-1], "fp1": FP_PLAN["fp2"][-1]}
        for name, mlp in FP_PLAN.items():
            setattr(self, name, FeaturePropagation(cins[name], mlp))
        self.conv1 = nn.Linear(FP_PLAN["fp1"][-1], feat_out)
        self.bn1 = MaskedBatchNorm(feat_out)

    def forward(self, xyz, pid, valid):
        l1 = self.sa1(xyz, pid, xyz, valid)
        l2 = self.sa2(*l1)
        l3 = self.sa3(*l2)
        l4 = self.sa4(*l3)
        p3 = self.fp4(l3[0], l4[0], l3[1], l4[1], l3[2], l4[2])
        p2 = self.fp3(l2[0], l3[0], l2[1], l3[1], l2[2], p3)
        p1 = self.fp2(l1[0], l2[0], l1[1], l2[1], l1[2], p2)
        p0 = self.fp1(xyz, l1[0], pid, l1[1], None, p1)
        return self.bn1(self.conv1(p0))


class DGCNN(nn.Module):
    """Piece-aware kNN edge-conv encoder: xyz [B, N, 3] -> features [B, N, feat_out]."""

    def __init__(self, feat_out: int = 128, k: int = 20, channels: Sequence[int] = (64, 64, 128)):
        super().__init__()
        self.k, self.depth = k, len(channels)
        cin = 3
        for li, ch in enumerate(channels):
            setattr(self, f"edge{li}", nn.Linear(2 * cin, ch))
            setattr(self, f"bn{li}", MaskedBatchNorm(ch))
            cin = ch
        self.head = nn.Linear(sum(channels), feat_out)

    def forward(self, xyz, pid, valid):
        _, idx = knn_piece_aware(xyz, pid, self.k)  # on xyz, the same for every layer
        h, feats = xyz, []
        for li in range(self.depth):
            nbr = index_points(h, idx)  # [B, N, k, C]
            centre = h[:, :, None, :].expand_as(nbr)
            e = getattr(self, f"bn{li}")(getattr(self, f"edge{li}")(
                torch.cat([nbr - centre, centre], dim=-1)))
            h = F.leaky_relu(e, 0.2).amax(dim=2)
            feats.append(h)
        return self.head(torch.cat(feats, dim=-1))
