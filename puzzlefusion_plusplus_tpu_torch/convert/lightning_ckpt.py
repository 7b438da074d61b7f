"""The original repo's Lightning checkpoints -> ``state_dict``s of the port's modules.

The port's counterpart of ``puzzlefusion_plusplus_tpu/convert/torch_ckpt.py``. The port's
modules carry the original repo's key names, so a conversion is prefix handling: the
VQ-VAE is under ``ae.`` in a denoiser-stage file (or ``encoder.`` in a denoiser or
AutoAgglomerative file), the denoiser under ``denoiser.``, the verifier under ``verifier.``.
Exactly the keys that the JAX converter maps are taken, so other keys of a file (the VQ-VAE
decoder's, the optimizer's) are left out, and a key it maps that the file lacks raises
rather than leaving a seeded tensor in place. Conv weights keep their 4-D / 3-D shapes;
BatchNorm's ``num_batches_tracked``, which older files lack, is 0 where absent.
"""

from __future__ import annotations

from typing import Mapping

import torch

PREFIXES = {"vqvae": ("ae.", "encoder."), "denoiser": ("denoiser.",),
            "verifier": ("verifier.",)}


def _n_layers(sd: Mapping, head: str, at: int) -> int:
    ids = {int(k.split(".")[at]) for k in sd if k.startswith(head)}
    if not ids:
        raise KeyError(f"no '{head}*' keys in the checkpoint")
    return 1 + max(ids)


def _linear(prefix: str) -> list[str]:
    return [prefix + ".weight", prefix + ".bias"]


def vqvae_keys(sd: Mapping) -> list[str]:
    """The keys of ``torch_ckpt.py::convert_vqvae``."""
    keys = []
    for sa in ("sa1", "sa2", "sa3"):
        for j in range(3):
            keys += _linear(f"pn2.{sa}.mlp_convs.{j}")
            bn = f"pn2.{sa}.mlp_bns.{j}"
            keys += _linear(bn) + [bn + ".running_mean", bn + ".running_var"]
    keys += _linear("pn2.conv6")
    for fc in ("fc1", "fc2", "fc3"):
        keys += _linear(f"pn2.{fc}")
    return keys + ["vector_quantization.embedding.weight"]


def denoiser_keys(sd: Mapping) -> list[str]:
    """The keys of ``torch_ckpt.py::convert_denoiser``."""
    keys = ["ref_part_emb.weight"] + _linear("shape_embedding") + _linear("param_fc")
    for i in range(_n_layers(sd, "transformer_layers.", 1)):
        p = f"transformer_layers.{i}"
        for norm in ("norm1", "norm2"):
            keys += [f"{p}.{norm}.emb.weight"] + _linear(f"{p}.{norm}.linear")
        for attn in ("self_attn", "global_attn"):
            keys += [f"{p}.{attn}.to_{x}.weight" for x in "qkv"]
            keys += _linear(f"{p}.{attn}.to_out.0")
        keys += _linear(f"{p}.norm3") + _linear(f"{p}.ff.net.0.proj") + _linear(f"{p}.ff.net.2")
    for head in ("mlp_out_trans", "mlp_out_rot"):
        for j in (0, 2, 4):
            keys += _linear(f"{head}.{j}")
    return keys


def verifier_keys(sd: Mapping) -> list[str]:
    """The keys of ``torch_ckpt.py::convert_verifier``."""
    keys = _linear("edge_feature_emb") + _linear("mlp_out")
    for i in range(_n_layers(sd, "transformer_encoder.layers.", 2)):
        p = f"transformer_encoder.layers.{i}"
        keys += [f"{p}.self_attn.in_proj_weight", f"{p}.self_attn.in_proj_bias"]
        for mod in ("self_attn.out_proj", "linear1", "linear2", "norm1", "norm2"):
            keys += _linear(f"{p}.{mod}")
    return keys


KEYS = {"vqvae": vqvae_keys, "denoiser": denoiser_keys, "verifier": verifier_keys}


def strip_prefix(sd: Mapping, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def convert(lightning_sd: Mapping, kind: str) -> dict:
    """A Lightning ``state_dict`` -> the ``state_dict`` of the port's ``kind`` module
    ('vqvae', 'denoiser' or 'verifier'). Raises KeyError naming the missing keys."""
    if kind not in PREFIXES:
        raise ValueError(f"kind must be one of {sorted(PREFIXES)}, got {kind!r}")
    sd = next((s for s in (strip_prefix(lightning_sd, p) for p in PREFIXES[kind]) if s), {})
    if not sd:
        raise KeyError(f"no {kind} keys (prefixes {PREFIXES[kind]}) in the checkpoint")
    keys = KEYS[kind](sd)
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"{kind} checkpoint lacks {len(missing)} keys: {missing[:8]}")
    out = {k: torch.as_tensor(sd[k]).detach().clone() for k in keys}
    if kind == "vqvae":
        for k in [k for k in keys if k.endswith(".running_mean")]:
            nbt = k[: -len("running_mean")] + "num_batches_tracked"
            out[nbt] = torch.as_tensor(sd.get(nbt, 0)).detach().clone()
    return out


def load_file(path: str, kind: str) -> dict:
    """Read a Lightning ``.ckpt`` (its tensors only) -> ``convert(..., kind)``."""
    return convert(torch.load(path, map_location="cpu", weights_only=True)["state_dict"], kind)
