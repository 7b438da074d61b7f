"""Attention layers of the matcher (port of ``puzzlefusion_plusplus_tpu/matching/layers.py``).

* ``MultiHeadAttention``: biasless q/k/v/out projections, masked scores filled with -1e9, the
  residual added before a LayerNorm (eps 1e-6). The softmax is written out: a fully masked
  row comes out uniform, as in the JAX package (``scaled_dot_product_attention`` with a
  boolean mask gives NaN there).
* ``PositionwiseFeedForward``, ``CrossAttentionLayer`` (x attends to x, then the FFN).
* ``BatchNormPoints``: BatchNorm over the channels of a flattened point set, optionally with
  per-point {0, 1} weights for the batch statistics (``models/vqvae.py::MaskedBatchNorm``).
* ``PointTransformerLayer``: vector attention over same-piece kNN groups (gathers through
  kernel G), the weights shared across the value heads.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from puzzlefusion_plusplus_tpu_torch.matching.ops import knn_piece_aware
from puzzlefusion_plusplus_tpu_torch.models.vqvae import MaskedBatchNorm
from puzzlefusion_plusplus_tpu_torch.ops.grouping import index_points

_NEG_INF = -1e9


class MultiHeadAttention(nn.Module):
    def __init__(self, num_heads: int = 8, dim: int = 512):
        super().__init__()
        self.num_heads = num_heads
        self.w_qs = nn.Linear(dim, dim, bias=False)
        self.w_ks = nn.Linear(dim, dim, bias=False)
        self.w_vs = nn.Linear(dim, dim, bias=False)
        self.fc = nn.Linear(dim, dim, bias=False)
        self.layer_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, q_in, k_in, v_in, mask=None):
        B, Tq, C = q_in.shape
        h = self.num_heads
        hd = C // h
        q = self.w_qs(q_in).reshape(B, Tq, h, hd)
        k = self.w_ks(k_in).reshape(B, -1, h, hd)
        v = self.w_vs(v_in).reshape(B, -1, h, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        if mask is not None:
            scores = torch.where(mask[:, None], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, Tq, C)
        return self.layer_norm(self.fc(out) + q_in)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w_1 = nn.Linear(dim, hidden)
        self.w_2 = nn.Linear(hidden, dim)
        self.layer_norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x):
        return self.layer_norm(self.w_2(torch.relu(self.w_1(x))) + x)


class CrossAttentionLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.attn = MultiHeadAttention(num_heads, dim)
        self.pos_ffn = PositionwiseFeedForward(dim, 2 * dim)

    def forward(self, x, mask=None):
        return self.pos_ffn(self.attn(x, x, x, mask))


class BatchNormPoints(MaskedBatchNorm):
    """BatchNorm over the last axis of x [..., C], every other axis flattened into points;
    ``weights`` (broadcastable to x[..., 0]) zero-weights points out of the statistics."""

    def forward(self, x, weights=None):
        shape = x.shape
        w = None if weights is None else weights.reshape(-1)
        return super().forward(x.reshape(-1, shape[-1]), w).reshape(shape)


class PointTransformerLayer(nn.Module):
    def __init__(self, in_feat: int, out_feat: int, n_heads: int = 8, n_sample: int = 16):
        super().__init__()
        C = out_feat
        self.n_heads, self.n_sample = n_heads, n_sample
        self.linear_q = nn.Linear(in_feat, C)
        self.linear_k = nn.Linear(in_feat, C)
        self.linear_v = nn.Linear(in_feat, C)
        # linear_p: Linear(3, 3) -> BN -> ReLU -> Linear(3, C)
        self.linear_p0 = nn.Linear(3, 3)
        self.linear_p_bn = BatchNormPoints(3)
        self.linear_p1 = nn.Linear(3, C)
        # linear_w: BN -> ReLU -> Linear(C, C/h) -> BN -> ReLU -> Linear(C/h, C/h)
        self.linear_w_bn0 = BatchNormPoints(C)
        self.linear_w0 = nn.Linear(C, C // n_heads)
        self.linear_w_bn1 = BatchNormPoints(C // n_heads)
        self.linear_w1 = nn.Linear(C // n_heads, C // n_heads)

    def forward(self, xyz, feats, pid):
        """xyz [B, N, 3], feats [B, N, in_feat], pid [B, N] -> [B, N, out_feat]."""
        B, N, _ = xyz.shape
        C, h, k = self.linear_q.out_features, self.n_heads, self.n_sample
        x_q, x_k, x_v = self.linear_q(feats), self.linear_k(feats), self.linear_v(feats)
        _, idx = knn_piece_aware(xyz, pid, k)  # [B, N, k], same piece
        k_nbr, v_nbr = index_points(x_k, idx), index_points(x_v, idx)
        p_nbr = index_points(xyz, idx) - xyz[:, :, None, :]
        p_r = self.linear_p1(torch.relu(self.linear_p_bn(self.linear_p0(p_nbr))))
        r_qk = k_nbr - x_q[:, :, None, :] + p_r
        w = self.linear_w0(torch.relu(self.linear_w_bn0(r_qk)))
        w = self.linear_w1(torch.relu(self.linear_w_bn1(w)))
        w = torch.softmax(w, dim=2)  # over the k neighbours
        vv = (v_nbr + p_r).reshape(B, N, k, h, C // h)
        return torch.einsum("bnksi,bnki->bnsi", vv, w).reshape(B, N, C)
