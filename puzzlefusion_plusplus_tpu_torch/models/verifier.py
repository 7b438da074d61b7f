"""Pairwise-alignment verifier transformer (port of
``puzzlefusion_plusplus_tpu/models/verifier.py``), eval mode.

Post-norm encoder layers with torch ``TransformerEncoderLayer`` semantics (packed
``in_proj_weight``, gelu FF), written out so that the key-padding mask is the same additive
-1e9 bias as in the JAX package. Parameter keys follow the original repo
(``transformer_encoder.layers.{i}.self_attn.in_proj_weight``, ``edge_feature_emb``,
``mlp_out``), which ``convert/torch_ckpt.py::convert_verifier`` reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from puzzlefusion_plusplus_tpu_torch.models.denoiser import NEG_INF, attention
from puzzlefusion_plusplus_tpu_torch.models.embeddings import sinusoidal_table


class PackedSelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x, bias):
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        return self.out_proj(attention(q, k, v, self.heads, bias))


class TorchEncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, ff_dim: int):
        super().__init__()
        self.self_attn = PackedSelfAttention(dim, heads)
        self.linear1 = nn.Linear(dim, ff_dim)
        self.linear2 = nn.Linear(ff_dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, key_bias):
        x = self.norm1(x + self.self_attn(x, key_bias))
        return self.norm2(x + self.linear2(F.gelu(self.linear1(x))))


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class VerifierTransformer(nn.Module):
    def __init__(self, embed_dim: int = 256, num_layers: int = 6, num_heads: int = 8,
                 max_nodes: int = 20, num_features: int = 7, ff_dim: int = 2048):
        super().__init__()
        self.embed_dim = embed_dim
        self.edge_feature_emb = nn.Linear(num_features, embed_dim)
        self.transformer_encoder = _Encoder(
            [TorchEncoderLayer(embed_dim, num_heads, ff_dim) for _ in range(num_layers)]
        )
        self.mlp_out = nn.Linear(embed_dim, 1)
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(max_nodes, embed_dim // 2)),
            persistent=False,
        )

    def forward(self, edge_features, edge_indices, edge_valids):
        """edge_features [B, E, 7], edge_indices [B, E, 2] int, edge_valids [B, E] {0,1}
        -> logits [B, E, 1]."""
        B, E, _ = edge_indices.shape
        x = self.pe[edge_indices.long()].reshape(B, E, self.embed_dim)
        x = x + self.edge_feature_emb(edge_features)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        neg = torch.full((), NEG_INF, dtype=x.dtype, device=x.device)
        key_bias = torch.where(edge_valids.bool(), zero, neg)[:, None, None, :]
        for layer in self.transformer_encoder.layers:
            x = layer(x, key_bias)
        return self.mlp_out(x)
