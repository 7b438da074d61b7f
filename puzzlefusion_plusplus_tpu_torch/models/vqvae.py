"""VQ-VAE fragment encoder, frozen-eval use only (port of
``puzzlefusion_plusplus_tpu/models/vqvae.py``).

The module holds the original repo's parameters under its keys (``pn2.sa1.mlp_convs.0`` as a
1x1 ``Conv2d``, ``pn2.sa1.mlp_bns.0`` as ``BatchNorm2d``, ``pn2.conv6`` as a 1x1 ``Conv1d``,
the decoder's ``pn2.fc1..3`` and ``vector_quantization.embedding``), so that
``convert/torch_ckpt.py::convert_vqvae`` reads its ``state_dict`` unchanged. The forward
runs through ``inference/sampler.py::FrozenEncoder``, which folds eval-mode BatchNorm into
the weights once; the decoder and training-mode BatchNorm belong to the training slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from puzzlefusion_plusplus_tpu_torch.ops.fps import farthest_point_sample
from puzzlefusion_plusplus_tpu_torch.ops.grouping import index_points, query_ball_point
from puzzlefusion_plusplus_tpu_torch.ops.sa_fused import fold_batchnorm

SA_RADII = (0.2, 0.4, 0.8)
SA_MLPS = ((64, 64, 128), (128, 128, 256), (256, 256, 512))


def sa_stage_indices(xyz: torch.Tensor, npoint: int, radius: float, nsample: int):
    """(fps_idx [B, S] int32, group_idx [B, S, K] int32); invariant under rigid rotation."""
    fps_idx = farthest_point_sample(xyz, npoint)
    new_xyz = index_points(xyz, fps_idx)
    return fps_idx, query_ball_point(radius, nsample, xyz, new_xyz)


def pn2_grouping_geometry(
    xyz: torch.Tensor,
    num_point: int = 25,
    sa_npoints: Sequence[int] = (256, 128),
    sa_nsamples: Sequence[int] = (32, 64, 64),
):
    """Stage indices plus per-stage (new_xyz [B, S, 3], grouped_rel [B, S, K, 3]) of the
    unrotated cloud; a rotation commutes with gather-and-recenter, so the sampler rotates
    these per step instead of regrouping."""
    npoints = (sa_npoints[0], sa_npoints[1], num_point)
    idx_stages, geom_stages = [], []
    pts = xyz
    for stage in range(3):
        fps_idx, group_idx = sa_stage_indices(
            pts, npoints[stage], SA_RADII[stage], sa_nsamples[stage]
        )
        centres = index_points(pts, fps_idx)
        grouped = index_points(pts, group_idx) - centres[:, :, None, :]
        idx_stages.append((fps_idx, group_idx))
        geom_stages.append((centres, grouped))
        pts = centres
    return tuple(idx_stages), tuple(geom_stages)


class SetAbstraction(nn.Module):
    """Parameters of one PointNet++ SSG stage: three 1x1 convs, each with BatchNorm."""

    def __init__(self, cin: int, mlp: Sequence[int]):
        super().__init__()
        self.mlp_convs = nn.ModuleList()
        self.mlp_bns = nn.ModuleList()
        for c in mlp:
            self.mlp_convs.append(nn.Conv2d(cin, c, 1))
            self.mlp_bns.append(nn.BatchNorm2d(c))
            cin = c


class PN2(nn.Module):
    def __init__(self, num_dim: int = 64, local_decode_pts: int = 40):
        super().__init__()
        self.sa1 = SetAbstraction(3, SA_MLPS[0])
        self.sa2 = SetAbstraction(SA_MLPS[0][-1] + 3, SA_MLPS[1])
        self.sa3 = SetAbstraction(SA_MLPS[1][-1] + 3, SA_MLPS[2])
        self.conv6 = nn.Conv1d(SA_MLPS[2][-1], num_dim, 1)
        self.fc1 = nn.Linear(num_dim, 256)
        self.fc2 = nn.Linear(256, 512)
        self.fc3 = nn.Linear(512, local_decode_pts * 3)


class VectorQuantizer(nn.Module):
    def __init__(self, n_e: int = 1024, e_dim: int = 16):
        super().__init__()
        self.embedding = nn.Embedding(n_e, e_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / n_e, 1.0 / n_e)


class VQVAE(nn.Module):
    def __init__(
        self,
        n_embeddings: int = 1024,
        embedding_dim: int = 16,
        num_point: int = 25,
        num_dim: int = 64,
        local_decode_pts: int = 40,
        sa_npoints: Sequence[int] = (256, 128),
        sa_nsamples: Sequence[int] = (32, 64, 64),
    ):
        super().__init__()
        self.num_point = num_point
        self.num_dim = num_dim
        self.embedding_dim = embedding_dim
        self.sa_npoints = tuple(sa_npoints)
        self.sa_nsamples = tuple(sa_nsamples)
        self.pn2 = PN2(num_dim, local_decode_pts)
        self.vector_quantization = VectorQuantizer(n_embeddings, embedding_dim)

    def folded_weights(self) -> dict:
        """Eval-mode weights with BatchNorm folded in: per stage three (kernel [in, out],
        bias [out]), plus conv6 (kernel, bias) and the codebook."""
        out = {}
        for name in ("sa1", "sa2", "sa3"):
            sa = getattr(self.pn2, name)
            layers = []
            for conv, bn in zip(sa.mlp_convs, sa.mlp_bns):
                kernel = conv.weight.reshape(conv.out_channels, conv.in_channels).T
                layers.append(fold_batchnorm(
                    kernel, conv.bias, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                    bn.eps,
                ))
            out[name] = layers
        conv6 = self.pn2.conv6
        out["conv6"] = (conv6.weight.reshape(conv6.out_channels, -1).T, conv6.bias)
        out["codebook"] = self.vector_quantization.embedding.weight
        return {k: _detached(v) for k, v in out.items()}


def _detached(v):
    if isinstance(v, torch.Tensor):
        return v.detach().contiguous()
    return type(v)(_detached(x) for x in v)
