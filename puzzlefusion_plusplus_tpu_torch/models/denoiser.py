"""SE(3) pose-diffusion denoiser transformer (port of
``puzzlefusion_plusplus_tpu/models/denoiser.py``), eval mode.

Parameters carry the original repo's keys (``transformer_layers.{i}.norm1.emb``,
``...self_attn.to_q``, ``...to_out.0``, ``...ff.net.0.proj``, ``mlp_out_trans.{0,2,4}``), which
``convert/torch_ckpt.py::convert_denoiser`` reads. The attention masks are additive -1e9
biases applied before a plain softmax, exactly as the JAX package builds them; a boolean
mask through ``scaled_dot_product_attention`` would treat fully masked rows differently.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from puzzlefusion_plusplus_tpu_torch.models.embeddings import nerf_embed, sinusoidal_table

NEG_INF = -1e9


class AdaLayerNorm(nn.Module):
    """LayerNorm modulated by a learned per-timestep scale/shift."""

    def __init__(self, dim: int, num_embeddings: int):
        super().__init__()
        self.emb = nn.Embedding(num_embeddings, dim)
        self.linear = nn.Linear(dim, 2 * dim)

    def forward(self, x, timestep):
        scale, shift = self.linear(F.silu(self.emb(timestep))).chunk(2, dim=-1)
        x = F.layer_norm(x, x.shape[-1:], eps=1e-5)
        return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def attention(q, k, v, heads: int, bias):
    """q/k/v [B, T, C] -> [B, T, C]: softmax(q k^T / sqrt(hd) + bias) v per head."""
    B, T, C = q.shape
    hd = C // heads
    q, k, v = (t.reshape(B, T, heads, hd).transpose(1, 2) for t in (q, k, v))
    scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
    if bias is not None:
        scores = scores + bias
    out = torch.softmax(scores, dim=-1) @ v
    return out.transpose(1, 2).reshape(B, T, C)


class Attention(nn.Module):
    """diffusers-style attention: biasless q/k/v, biased out-projection ``to_out.0``."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Dropout(0.0)])

    def forward(self, x, bias):
        out = attention(self.to_q(x), self.to_k(x), self.to_v(x), self.heads, bias)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(0.0),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class EncoderLayer(nn.Module):
    """AdaLN -> part-local attention -> AdaLN -> global attention -> LN -> GEGLU FF."""

    def __init__(self, dim: int, heads: int, num_ada: int):
        super().__init__()
        self.norm1 = AdaLayerNorm(dim, num_ada)
        self.self_attn = Attention(dim, heads)
        self.norm2 = AdaLayerNorm(dim, num_ada)
        self.global_attn = Attention(dim, heads)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, self_bias, gen_bias, timestep):
        x = x + self.self_attn(self.norm1(x, timestep), self_bias)
        x = x + self.global_attn(self.norm2(x, timestep), gen_bias)
        return x + self.ff(self.norm3(x))


def _pose_head(dim: int, out: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(dim, dim), nn.SiLU(), nn.Linear(dim, dim // 2), nn.SiLU(),
                         nn.Linear(dim // 2, out))


class DenoiserTransformer(nn.Module):
    def __init__(
        self,
        embed_dim: int = 512,
        num_layers: int = 6,
        num_heads: int = 8,
        num_dim: int = 64,
        max_parts: int = 20,
        multires: int = 10,
        num_ada_embeds: int = 3072,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.multires = multires
        self.ref_part_emb = nn.Embedding(2, embed_dim)
        self.transformer_layers = nn.ModuleList(
            [EncoderLayer(embed_dim, num_heads, num_ada_embeds) for _ in range(num_layers)]
        )
        nerf = 1 + 2 * multires
        self.shape_embedding = nn.Linear(num_dim + 3 * nerf + nerf, embed_dim)
        self.param_fc = nn.Linear(7 * nerf, embed_dim)
        self.mlp_out_trans = _pose_head(embed_dim, 3)
        self.mlp_out_rot = _pose_head(embed_dim, 4)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(max_parts, embed_dim)), persistent=False
        )

    def forward(self, x, timesteps, latent, xyz, part_valids, scale, ref_part):
        """x [B, P, 7], timesteps [B] int, latent [B, P, L, num_dim], xyz [B, P, L, 3],
        part_valids [B, P], scale [B, P, 1], ref_part [B, P] bool -> [B, P, 7]."""
        B, P, L, _ = latent.shape
        C, T = self.embed_dim, P * L
        scale_emb = nerf_embed(scale, self.multires)[:, :, None, :].expand(B, P, L, -1)
        xyz_emb = nerf_embed(xyz, self.multires)
        shape_emb = self.shape_embedding(torch.cat([latent, xyz_emb, scale_emb], dim=-1))
        x_emb = self.param_fc(nerf_embed(x, self.multires))
        x_emb = x_emb + self.ref_part_emb.weight[ref_part.long()]
        data = x_emb[:, :, None, :] + shape_emb + self.pe[:P][None, :, None, :]
        data = data.reshape(B, T, C)

        part_id = torch.arange(T, device=x.device) // L
        zero = torch.zeros((), dtype=data.dtype, device=x.device)
        neg = torch.full((), NEG_INF, dtype=data.dtype, device=x.device)
        self_bias = torch.where(part_id[:, None] == part_id[None, :], zero, neg)[None, None]
        tok_valid = part_valids.bool().repeat_interleave(L, dim=1)
        gen_bias = torch.where(tok_valid, zero, neg)[:, None, None, :]
        for layer in self.transformer_layers:
            data = layer(data, self_bias, gen_bias, timesteps)

        out = data.reshape(B, P, L, C).mean(dim=2)
        return torch.cat([self.mlp_out_trans(out), self.mlp_out_rot(out)], dim=-1)
