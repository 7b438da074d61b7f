"""VQ-VAE fragment autoencoder (port of ``puzzlefusion_plusplus_tpu/models/vqvae.py``).

The module holds the original repo's parameters under its keys (``pn2.sa1.mlp_convs.0`` as a
1x1 ``Conv2d``, ``pn2.sa1.mlp_bns.0`` with BatchNorm2d's keys, ``pn2.conv6`` as a 1x1
``Conv1d``, the decoder's ``pn2.fc1..3`` and ``vector_quantization.embedding``), so that
``convert/torch_ckpt.py::convert_vqvae`` reads its ``state_dict`` unchanged. Activations are
channel-last, [M, S, K, C], as in the JAX package; each 1x1 conv runs as a linear layer.

Two uses: ``forward`` is the training model (train-mode ``MaskedBatchNorm``, the quantizer's
losses, the decoder), and ``folded_weights`` feeds the inference encoder
(``inference/sampler.py::FrozenEncoder``), which folds eval-mode BatchNorm into the weights.

``with_dtype(torch.bfloat16)`` is the JAX package's ``ae.clone(dtype=jnp.bfloat16)``, the
frozen encoder of ``trainer.precision=bf16``: each SA conv, conv6, fc1 and fc2 computes as
flax's ``nn.Dense(dtype=bf16)`` (``models/denoiser.py::dense``; the convs' outputs go straight
into fp32, into BatchNorm or the code selection, so they are ``promoted``), each BatchNorm in
fp32 returning bf16, fc3 in fp32; the code selection stays fp32. It
reaches the composable encode only: kernels S and R take the fp32 folded weights, as the JAX
package's fused encodes do.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from puzzlefusion_plusplus_tpu_torch.models.denoiser import dense
from puzzlefusion_plusplus_tpu_torch.ops.fps import farthest_point_sample
from puzzlefusion_plusplus_tpu_torch.ops.grouping import (
    index_points,
    index_points_matmul_safe,
    query_ball_point,
)
from puzzlefusion_plusplus_tpu_torch.ops.sa_fused import fold_batchnorm
from puzzlefusion_plusplus_tpu_torch.parallel import mesh
from puzzlefusion_plusplus_tpu_torch.utils import profiling

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


def _sum_over(group, x: torch.Tensor, grad: bool = False) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (``parallel/mesh.py``; with ``grad`` its
    backward sums the gradient too); ``x`` itself when ``group`` is None."""
    if group is None:
        return x
    return mesh.all_reduce_sum(x, group) if grad else mesh.global_sum(x, group)


@contextlib.contextmanager
def _stats_frozen(stage: nn.Module):
    """A checkpointed stage's second forward (in backward): BatchNorm's running statistics
    were already updated by the first, so they stay as they are."""
    bns = [m for m in stage.modules() if isinstance(m, MaskedBatchNorm)]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn in bns:
            bn.update_stats = True


class MaskedBatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel-last axis, with
    optional per-sample weights for the batch statistics (``MaskedBatchNorm`` of the JAX
    package): compaction repeats get weight 0, so the statistics are those of the valid
    parts. The running statistics move as ``0.9 old + 0.1 batch`` with the biased batch
    variance. Keeps BatchNorm2d's parameters and buffers under their names. It computes in
    fp32 and returns ``dtype`` (the compute dtype), or the input's dtype when that is None."""

    update_stats = True  # off while a checkpointed stage recomputes its forward
    group = None  # the ranks whose batch the statistics cover (``VQVAE.reduce_over``)
    dtype = None

    def forward(self, x: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
        out_dtype = self.dtype or x.dtype
        x = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            # the statistics of the group's batch: sums over its ranks, the variance in a
            # second pass around the group's mean
            red = tuple(range(x.dim() - 1))
            if weights is None:
                w = torch.ones((), dtype=x.dtype, device=x.device)
                # a blocking copy of the host's count to the device
                with profiling.span("pfpp.sync.bn_count"):
                    count = torch.tensor(float(x.numel() // x.shape[-1]), device=x.device)
            else:
                w = weights.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
                count = w.sum() * math.prod(x.shape[1:-1])
            denom = _sum_over(self.group, count).clamp_min(1e-6)
            mean = _sum_over(self.group, (x * w).sum(red), grad=True) / denom
            var = _sum_over(self.group, ((x - mean).square() * w).sum(red), grad=True) / denom
            if self.update_stats:
                m = 1.0 - self.momentum  # flax's momentum
                with torch.no_grad():
                    self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
                    self.num_batches_tracked.add_(1)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(out_dtype)


def _conv(x: torch.Tensor, conv: nn.Module, dtype: torch.dtype | None) -> torch.Tensor:
    """A 1x1 conv as a linear layer over the last axis; with ``dtype`` as ``dense`` computes
    it, promoted (a BatchNorm or the code selection takes the output in fp32)."""
    if dtype is None:
        return F.linear(x, conv.weight.flatten(1), conv.bias)
    return dense(x, conv, dtype, promoted=True)


class SetAbstraction(nn.Module):
    """One PointNet++ SSG stage: FPS, ball query, recentred grouping (features through
    kernel A), three 1x1 convs each with BatchNorm and ReLU, max over the neighbourhood."""

    dtype = None  # the compute dtype (``VQVAE.with_dtype``)

    def __init__(self, cin: int, mlp: Sequence[int], npoint: int, radius: float, nsample: int):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.mlp_convs = nn.ModuleList()
        self.mlp_bns = nn.ModuleList()
        for c in mlp:
            self.mlp_convs.append(nn.Conv2d(cin, c, 1))
            self.mlp_bns.append(MaskedBatchNorm(c))
            cin = c

    def forward(self, xyz: torch.Tensor, points: torch.Tensor | None,
                bn_mask: torch.Tensor | None = None, idx=None, geom=None,
                rot: torch.Tensor | None = None):
        """xyz [B, N, 3], points [B, N, D] or None -> (new_xyz [B, S, 3], feats [B, S, C]).

        ``idx``: cached (fps_idx, group_idx) of this stage, which skip FPS and the ball
        query (they are invariant under rigid rotation, so they may come from any rotation
        of ``xyz``). ``geom``: cached (new_xyz, grouped_rel) from ``pn2_grouping_geometry``,
        which skip the xyz gathers (``xyz`` is then unused). With ``rot``
        [B, 3, 3] the cached geometry is unrotated and the rotation is folded into conv0's
        xyz block: conv0(g R^T) = g (R^T K_xyz), and the centres come out rotated."""
        fps_idx, group_idx = (idx if idx is not None else
                              sa_stage_indices(xyz, self.npoint, self.radius, self.nsample))
        if geom is not None:
            new_xyz, grouped_xyz = geom
            if rot is not None:
                new_xyz = torch.einsum("bsd,bed->bse", new_xyz, rot)
        else:
            new_xyz = index_points(xyz, fps_idx)
            grouped_xyz = index_points(xyz, group_idx) - new_xyz[:, :, None, :]
        # conv0 sees cat(grouped_xyz, grouped_feats); the features go through kernel A
        feats = None if points is None else index_points_matmul_safe(points, group_idx)
        conv0, dt = self.mlp_convs[0], self.dtype
        w0 = conv0.weight.flatten(1)  # [C, 3 + D]
        if geom is not None and rot is not None and dt is None:
            w_eff = torch.einsum("bed,ce->bdc", rot, w0[:, :3])  # R^T K_xyz, [B, 3, C]
            h = torch.einsum("bskd,bdc->bskc", grouped_xyz, w_eff)
            h = h + (conv0.bias if feats is None else F.linear(feats, w0[:, 3:], conv0.bias))
        elif geom is not None and rot is not None:
            # as the JAX module: R^T K_xyz = conv0(R^T rows) - conv0(0) (conv0 in dt, the
            # difference promoted by the fp32 product with the geometry), plus conv0 of the
            # features (promoted)
            b = conv0.bias.to(dt)
            w_eff = torch.einsum("bed,ce->bdc", rot.to(dt), w0[:, :3].to(dt)) + b
            h = torch.einsum("bskd,bdc->bskc", grouped_xyz, w_eff.float() - b.float())
            h = h + (b.float() if feats is None else
                     F.linear(feats.to(dt), w0[:, 3:].to(dt)).float() + b.float())
        else:
            h = grouped_xyz if feats is None else torch.cat([grouped_xyz, feats], dim=-1)
            h = _conv(h, conv0, dt)
        for j, (conv, bn) in enumerate(zip(self.mlp_convs, self.mlp_bns)):
            if j:
                h = _conv(h, conv, dt)
            h = torch.relu(bn(h, bn_mask))
        return new_xyz, h.amax(dim=2)


class PN2(nn.Module):
    """PointNet++ SSG encoder to ``num_point`` tokens plus the FC offset decoder. With
    ``remat`` each SA stage is recomputed in backward instead of keeping its grouped
    [M, S, K, C] activations (``torch.utils.checkpoint``, the JAX package's ``nn.remat``)."""

    def __init__(self, num_point: int = 25, num_dim: int = 64, local_decode_pts: int = 40,
                 sa_npoints: Sequence[int] = (256, 128),
                 sa_nsamples: Sequence[int] = (32, 64, 64), remat: bool = True):
        super().__init__()
        self.num_point, self.local_decode_pts, self.remat = num_point, local_decode_pts, remat
        self.dtype = None
        npoints = (sa_npoints[0], sa_npoints[1], num_point)
        cins = (3, SA_MLPS[0][-1] + 3, SA_MLPS[1][-1] + 3)
        for i, name in enumerate(("sa1", "sa2", "sa3")):
            setattr(self, name, SetAbstraction(cins[i], SA_MLPS[i], npoints[i], SA_RADII[i],
                                               sa_nsamples[i]))
        self.conv6 = nn.Conv1d(SA_MLPS[2][-1], num_dim, 1)
        self.fc1 = nn.Linear(num_dim, 256)
        self.fc2 = nn.Linear(256, 512)
        self.fc3 = nn.Linear(512, local_decode_pts * 3)

    def _stage(self, sa: SetAbstraction, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(sa, *args, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(), _stats_frozen(sa)))
        return sa(*args)

    def encode(self, xyz: torch.Tensor, bn_mask: torch.Tensor | None = None, cached_idx=None,
               cached_geom=None, rot: torch.Tensor | None = None):
        """xyz [B, N, 3] -> (z_e [B, num_point, num_dim], token centres [B, num_point, 3]).
        ``cached_idx`` / ``cached_geom`` (per stage, from ``pn2_grouping_geometry``) and
        ``rot`` are ``SetAbstraction.forward``'s ``idx`` / ``geom`` / ``rot``."""
        i1, i2, i3 = cached_idx if cached_idx is not None else (None, None, None)
        g1, g2, g3 = cached_geom if cached_geom is not None else (None, None, None)
        l1_xyz, l1 = self._stage(self.sa1, xyz, None, bn_mask, i1, g1, rot)
        l2_xyz, l2 = self._stage(self.sa2, l1_xyz, l1, bn_mask, i2, g2, rot)
        l3_xyz, l3 = self._stage(self.sa3, l2_xyz, l2, bn_mask, i3, g3, rot)
        return _conv(l3, self.conv6, self.dtype), l3_xyz

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, L, C] -> per-token point offsets [B, L, local_decode_pts, 3] (fc3 in fp32)."""
        x = torch.relu(dense(torch.relu(dense(z, self.fc1, self.dtype)), self.fc2, self.dtype))
        return self.fc3(x.float()).reshape(z.shape[0], self.num_point, self.local_decode_pts, 3)


class VectorQuantizer(nn.Module):
    group = None  # the ranks whose batch the loss and perplexity cover (``VQVAE.reduce_over``)

    def __init__(self, n_e: int = 1024, e_dim: int = 16, beta: float = 0.25):
        super().__init__()
        self.n_e, self.e_dim, self.beta = n_e, e_dim, beta
        self.embedding = nn.Embedding(n_e, e_dim)
        nn.init.uniform_(self.embedding.weight, -1.0 / n_e, 1.0 / n_e)

    def nearest(self, z: torch.Tensor) -> torch.Tensor:
        """z [..., e_dim] -> index of the nearest code (expanded L2, first minimum on ties)."""
        cb = self.embedding.weight
        flat = z.reshape(-1, self.e_dim)
        d = flat.square().sum(1, keepdim=True) + cb.square().sum(1) - 2.0 * flat @ cb.T
        return d.argmin(1).reshape(z.shape[:-1])

    def forward(self, z: torch.Tensor, mask: torch.Tensor | None = None):
        """z [B, T, e_dim] -> (embedding_loss, z_q (straight-through), perplexity,
        codes [B, T]). ``mask`` [B] {0,1}: losses and perplexity over the masked samples."""
        cb = self.embedding.weight
        codes = self.nearest(z)
        z_q = cb[codes]
        sq_to_code = (z_q.detach() - z).square()
        sq_to_z = (z_q - z.detach()).square()
        onehot = F.one_hot(codes, self.n_e).to(z.dtype)  # [B, T, n_e]
        # over the group's batch: the loss is this rank's share (a local sum over the
        # group's count), the perplexity that of the group's summed code histogram
        w = (torch.ones((z.shape[0], 1, 1), dtype=z.dtype, device=z.device) if mask is None
             else mask.to(z.dtype).reshape(-1, 1, 1))
        n = _sum_over(self.group, w.sum())
        denom = (n * z.shape[1] * z.shape[2]).clamp_min(1.0)
        loss = (sq_to_code * w).sum() / denom + self.beta * (sq_to_z * w).sum() / denom
        e_mean = (_sum_over(self.group, (onehot * w).sum((0, 1)))
                  / (n * z.shape[1]).clamp_min(1.0))
        perplexity = torch.exp(-(e_mean * torch.log(e_mean + 1e-10)).sum())
        return loss, z + (z_q - z).detach(), perplexity, codes


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
        beta: float = 0.25,
        remat: bool = True,
    ):
        super().__init__()
        self.num_point = num_point
        self.num_dim = num_dim
        self.embedding_dim = embedding_dim
        self.local_decode_pts = local_decode_pts
        self.sa_npoints = tuple(sa_npoints)
        self.sa_nsamples = tuple(sa_nsamples)
        self.pn2 = PN2(num_point, num_dim, local_decode_pts, sa_npoints, sa_nsamples, remat)
        self.vector_quantization = VectorQuantizer(n_embeddings, embedding_dim, beta)

    def with_dtype(self, dtype: torch.dtype | None) -> "VQVAE":
        """Compute in ``dtype`` (None: fp32), the parameters kept fp32 (the module note)."""
        self.pn2.dtype = dtype
        for m in self.modules():
            if isinstance(m, (SetAbstraction, MaskedBatchNorm)):
                m.dtype = dtype
        return self

    def reduce_over(self, group) -> "VQVAE":
        """Compute the batch statistics (train-mode BatchNorm's, the quantizer's loss count
        and perplexity) over the batch of ``group``'s ranks, as a data-parallel trainer asks
        (``parallel/mesh.py::data_group``); None, the default, keeps them this process's."""
        for m in self.modules():
            if isinstance(m, (MaskedBatchNorm, VectorQuantizer)):
                m.group = group
        return self

    def forward(self, part_pcs: torch.Tensor, mask: torch.Tensor | None = None) -> dict:
        """part_pcs [B, N, 3] -> reconstruction offsets and quantizer outputs. ``mask`` [B]
        {0,1}: sample validity for the quantizer losses and, in training mode, the
        BatchNorm statistics (compaction repeats carry weight 0)."""
        z_e, xyz = self.pn2.encode(part_pcs, mask if self.training else None)
        z_e = z_e.float()  # the code selection does not depend on the compute dtype
        B, L, _ = z_e.shape
        loss, z_q, perplexity, codes = self.vector_quantization(z_e.reshape(B, 4 * L, -1), mask)
        z_q = z_q.reshape(B, L, -1)
        return {"embedding_loss": loss, "pc_offset": self.pn2.decode(z_q),
                "perplexity": perplexity, "xyz": xyz, "z_q": z_q, "code_idx": codes}

    def encode(self, part_pcs: torch.Tensor, cached_idx=None, cached_geom=None,
               rot: torch.Tensor | None = None) -> dict:
        """The composable encode of the frozen encoder (eval-mode BatchNorm when the module is
        in eval mode): part_pcs [B, N, 3] -> z_q [B, L, num_dim] (the nearest codes, chosen
        in fp32), token centres xyz [B, L, 3] and the unquantized z_e. The cached arguments
        are ``PN2.encode``'s."""
        z_e, xyz = self.pn2.encode(part_pcs, None, cached_idx, cached_geom, rot)
        z_e = z_e.float()  # the code selection does not depend on the compute dtype
        B, L, _ = z_e.shape
        codes = self.vector_quantization.nearest(z_e.reshape(B, 4 * L, -1))
        z_q = self.vector_quantization.embedding.weight[codes].reshape(B, L, -1)
        return {"z_q": z_q, "xyz": xyz, "z_e": z_e}

    def reconstruction(self, out: dict) -> torch.Tensor:
        """Offsets + token centres -> [B, num_point * local_decode_pts, 3]."""
        pc = out["pc_offset"] + out["xyz"][:, :, None, :]
        return pc.reshape(pc.shape[0], self.num_point * self.local_decode_pts, 3)

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
