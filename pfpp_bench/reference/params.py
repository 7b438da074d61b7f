"""The three models' parameters: names, shapes and how the benchmark draws them.

Names follow the original PuzzleFusion++ checkpoints' keys, which the program's modules also
carry, so one dict of tensors loads into both. ``draw`` makes every tensor from one seeded
generator on the device in one call: weights are normal with the standard deviation of
PyTorch's default uniform init (1 / sqrt(3 fan_in)), biases likewise, embeddings standard
normal, the codebook at its own init's scale, norms at one and zero.

The verifier's output layer is drawn at a tenth of that scale. Its logits then stay near 0,
far from the 0.9 threshold of ``sigmoid``, so that no edge is predicted: no merge fires
(the reference has no merge path), no part is promoted to the reference set and no shape
exits early, so every call runs all its iterations. The benchmark covers the verifier's
forward, not the promotion, the early exit or the merge path (PERF.md says so).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pfpp_bench.seeds import derive

SA_MLPS = ((64, 64, 128), (128, 128, 256), (256, 256, 512))
VERIFIER_OUT_SCALE = 0.1


def _linear(name: str, out_f: int, in_f: int, bias: bool = True, conv: int = 0,
            scale: float = 1.0) -> list:
    std = scale / math.sqrt(3.0 * in_f)
    shape = (out_f, in_f) + (1,) * conv
    spec = [(f"{name}.weight", shape, "normal", std)]
    if bias:
        spec.append((f"{name}.bias", (out_f,), "normal", std))
    return spec


def _norm(name: str, dim: int, stats: bool = False) -> list:
    spec = [(f"{name}.weight", (dim,), "one", 0.0), (f"{name}.bias", (dim,), "zero", 0.0)]
    if stats:
        spec += [(f"{name}.running_mean", (dim,), "zero", 0.0),
                 (f"{name}.running_var", (dim,), "one", 0.0)]
    return spec


def vqvae_spec(c: dict) -> list:
    """The VQ-VAE: three SA stages of 1x1 convs with BatchNorm, conv6, the decoder's fc1-3,
    the codebook."""
    spec = []
    cin = 3
    for s, mlp in enumerate(SA_MLPS):
        for j, cout in enumerate(mlp):
            spec += _linear(f"pn2.sa{s + 1}.mlp_convs.{j}", cout, cin, conv=2)
            spec += _norm(f"pn2.sa{s + 1}.mlp_bns.{j}", cout, stats=True)
            cin = cout
        cin += 3
    spec += _linear("pn2.conv6", c["num_dim"], SA_MLPS[2][-1], conv=1)
    spec += _linear("pn2.fc1", 256, c["num_dim"])
    spec += _linear("pn2.fc2", 512, 256)
    spec += _linear("pn2.fc3", c["local_decode_pts"] * 3, 512)
    n_e = c["n_embeddings"]
    spec.append(("vector_quantization.embedding.weight", (n_e, c["embedding_dim"]), "normal",
                 1.0 / (n_e * math.sqrt(3.0))))
    return spec


def denoiser_spec(c: dict, ddpm_steps: int) -> list:
    C = c["embed_dim"]
    nerf = 1 + 2 * c["multires"]
    n_ada = max(6 * C, ddpm_steps)
    spec = [("ref_part_emb.weight", (2, C), "normal", 1.0)]
    for i in range(c["num_layers"]):
        p = f"transformer_layers.{i}"
        for n in ("norm1", "norm2"):
            spec.append((f"{p}.{n}.emb.weight", (n_ada, C), "normal", 1.0))
            spec += _linear(f"{p}.{n}.linear", 2 * C, C)
        for a in ("self_attn", "global_attn"):
            for q in ("to_q", "to_k", "to_v"):
                spec += _linear(f"{p}.{a}.{q}", C, C, bias=False)
            spec += _linear(f"{p}.{a}.to_out.0", C, C)
        spec += _norm(f"{p}.norm3", C)
        spec += _linear(f"{p}.ff.net.0.proj", 8 * C, C)
        spec += _linear(f"{p}.ff.net.2", C, 4 * C)
    spec += _linear("shape_embedding", C, c["num_dim"] + 4 * nerf)
    spec += _linear("param_fc", C, 7 * nerf)
    for head, out in (("mlp_out_trans", 3), ("mlp_out_rot", 4)):
        spec += _linear(f"{head}.0", C, C)
        spec += _linear(f"{head}.2", C // 2, C)
        spec += _linear(f"{head}.4", out, C // 2)
    return spec


def verifier_spec(c: dict) -> list:
    D, ff = c["embed_dim"], c["ff_dim"]
    spec = _linear("edge_feature_emb", D, c["num_features"])
    for i in range(c["num_layers"]):
        p = f"transformer_encoder.layers.{i}"
        std = 1.0 / math.sqrt(3.0 * D)
        spec += [(f"{p}.self_attn.in_proj_weight", (3 * D, D), "normal", std),
                 (f"{p}.self_attn.in_proj_bias", (3 * D,), "normal", std)]
        spec += _linear(f"{p}.self_attn.out_proj", D, D)
        spec += _linear(f"{p}.linear1", ff, D)
        spec += _linear(f"{p}.linear2", D, ff)
        spec += _norm(f"{p}.norm1", D) + _norm(f"{p}.norm2", D)
    spec += _linear("mlp_out", 1, D, scale=VERIFIER_OUT_SCALE)
    return spec


def draw(spec: list, seed: int, device, salt: int = 0) -> dict:
    """Every tensor of ``spec`` from one normal draw of a generator seeded from ``seed``
    and ``salt`` on ``device``."""
    sizes = [int(np.prod(shape)) for _, shape, kind, _ in spec if kind == "normal"]
    g = torch.Generator(device=device).manual_seed(derive(seed, salt))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, off = {}, 0
    for name, shape, kind, std in spec:
        if kind == "normal":
            n = int(np.prod(shape))
            out[name] = (flat[off:off + n] * std).reshape(shape)
            off += n
        else:
            out[name] = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device)
    return out

