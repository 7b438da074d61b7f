"""Flax parameter trees -> torch ``state_dict``s of the port's modules.

Each function takes the flax tree as nested dicts of numpy arrays (what ``jax.device_get``
returns from a checkpoint or an ``init``) and imports nothing from JAX. Keys are the original
repo's, so ``puzzlefusion_plusplus_tpu/convert/torch_ckpt.py::convert_*`` applied to the
result gives the flax tree back. Dense kernels are [in, out] in flax and [out, in] in torch.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _linear(p: Mapping, prefix: str, sd: dict) -> None:
    sd[prefix + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[prefix + ".bias"] = _t(p["bias"])


def _norm(p: Mapping, prefix: str, sd: dict) -> None:
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def vqvae_state_dict(params: Mapping, batch_stats: Mapping) -> dict:
    """VQ-VAE {params, batch_stats} -> ``models/vqvae.py::VQVAE`` state_dict."""
    p, bs = params["pn2"], batch_stats["pn2"]
    sd: dict = {}
    for sa in ("sa1", "sa2", "sa3"):
        for j in range(3):
            conv = p[sa][f"conv{j}"]
            sd[f"pn2.{sa}.mlp_convs.{j}.weight"] = _t(np.asarray(conv["kernel"]).T[:, :, None, None])
            sd[f"pn2.{sa}.mlp_convs.{j}.bias"] = _t(conv["bias"])
            bn = f"pn2.{sa}.mlp_bns.{j}"
            _norm(p[sa][f"bn{j}"], bn, sd)
            sd[bn + ".running_mean"] = _t(bs[sa][f"bn{j}"]["mean"])
            sd[bn + ".running_var"] = _t(bs[sa][f"bn{j}"]["var"])
            sd[bn + ".num_batches_tracked"] = torch.tensor(0)
    sd["pn2.conv6.weight"] = _t(np.asarray(p["conv6"]["kernel"]).T[:, :, None])
    sd["pn2.conv6.bias"] = _t(p["conv6"]["bias"])
    for fc in ("fc1", "fc2", "fc3"):
        _linear(p[fc], f"pn2.{fc}", sd)
    sd["vector_quantization.embedding.weight"] = _t(
        params["vector_quantization"]["embedding"]
    )
    return sd


def denoiser_state_dict(params: Mapping) -> dict:
    """Denoiser params -> ``models/denoiser.py::DenoiserTransformer`` state_dict."""
    sd: dict = {"ref_part_emb.weight": _t(params["ref_part_emb"]["embedding"])}
    _linear(params["shape_embedding"], "shape_embedding", sd)
    _linear(params["param_fc"], "param_fc", sd)
    n_layers = sum(1 for k in params if k.startswith("layer"))
    for i in range(n_layers):
        lp, pre = params[f"layer{i}"], f"transformer_layers.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{pre}.{norm}.emb.weight"] = _t(lp[norm]["emb"]["embedding"])
            _linear(lp[norm]["linear"], f"{pre}.{norm}.linear", sd)
        for attn in ("self_attn", "global_attn"):
            for proj in ("to_q", "to_k", "to_v"):
                _linear(lp[attn][proj], f"{pre}.{attn}.{proj}", sd)
            _linear(lp[attn]["to_out"], f"{pre}.{attn}.to_out.0", sd)
        _norm(lp["norm3"], f"{pre}.norm3", sd)
        _linear(lp["ff"]["proj"], f"{pre}.ff.net.0.proj", sd)
        _linear(lp["ff"]["out"], f"{pre}.ff.net.2", sd)
    for head in ("mlp_out_trans", "mlp_out_rot"):
        for j in (0, 2, 4):
            _linear(params[head][f"layers_{j}"], f"{head}.{j}", sd)
    return sd


def verifier_state_dict(params: Mapping) -> dict:
    """Verifier params -> ``models/verifier.py::VerifierTransformer`` state_dict."""
    sd: dict = {}
    _linear(params["edge_feature_emb"], "edge_feature_emb", sd)
    _linear(params["mlp_out"], "mlp_out", sd)
    n_layers = sum(1 for k in params if k.startswith("layer"))
    for i in range(n_layers):
        lp, pre = params[f"layer{i}"], f"transformer_encoder.layers.{i}"
        qkv = [lp[k] for k in ("q_proj", "k_proj", "v_proj")]
        sd[f"{pre}.self_attn.in_proj_weight"] = _t(
            np.concatenate([np.asarray(p["kernel"]).T for p in qkv], axis=0)
        )
        sd[f"{pre}.self_attn.in_proj_bias"] = _t(np.concatenate([p["bias"] for p in qkv]))
        _linear(lp["out_proj"], f"{pre}.self_attn.out_proj", sd)
        _linear(lp["linear1"], f"{pre}.linear1", sd)
        _linear(lp["linear2"], f"{pre}.linear2", sd)
        _norm(lp["norm1"], f"{pre}.norm1", sd)
        _norm(lp["norm2"], f"{pre}.norm2", sd)
    return sd


def matching_state_dict(params: Mapping, batch_stats: Mapping) -> dict:
    """Matcher {params, batch_stats} -> ``matching/model.py::JigsawModel`` state_dict. The
    torch modules carry the flax names, so a key is the flax path joined by dots, with the
    ``BatchNorm_0`` level of ``BatchNormPoints`` dropped: Dense kernel -> Linear weight
    (transposed), BatchNorm and LayerNorm scale -> weight, mean/var -> running_mean /
    running_var, ``affinity_layer/A`` as it is."""
    sd: dict = {}

    def walk(p: Mapping, path: tuple) -> None:
        prefix = ".".join(k for k in path if k != "BatchNorm_0")
        if "kernel" in p:
            _linear(p, prefix, sd)
        elif "scale" in p:
            _norm(p, prefix, sd)
        for k, v in p.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            elif k == "A":
                sd[f"{prefix}.A" if prefix else "A"] = _t(v)

    def walk_stats(s: Mapping, path: tuple) -> None:
        if "mean" in s:
            prefix = ".".join(k for k in path if k != "BatchNorm_0")
            sd[prefix + ".running_mean"] = _t(s["mean"])
            sd[prefix + ".running_var"] = _t(s["var"])
            sd[prefix + ".num_batches_tracked"] = torch.tensor(0)
            return
        for k, v in s.items():
            walk_stats(v, path + (k,))

    walk(params, ())
    walk_stats(batch_stats, ())
    return sd
