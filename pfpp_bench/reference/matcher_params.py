"""The Jigsaw matcher's parameters: names, shapes and how the benchmark draws them.

Names follow the program's matcher (``encoder.sa1.conv0_0.weight``, ``tf_cross1.attn.w_qs``,
``affinity_layer.A``), so that one dict of tensors loads into both. The widths come from the
configuration file's ``model`` (the published PointNet++ MSG plan of Jigsaw's
``pointnet2_msg.py``, the transformer and affinity widths). ``draw`` makes every tensor from
one seeded generator on the device in one call, at the scales of the model's own init:
dense weights normal with variance 1 / fan_in (flax's ``lecun_normal``, not truncated),
dense biases 0, norms at one and zero, and the affinity's A the identity plus a normal of
the variance of its uniform init.
"""

from __future__ import annotations

import math

import torch

from pfpp_bench.reference import params as ref_params


def _dense(name: str, out_f: int, in_f: int, bias: bool = True) -> list:
    spec = [(f"{name}.weight", (out_f, in_f), "normal", 1.0 / math.sqrt(in_f))]
    if bias:
        spec.append((f"{name}.bias", (out_f,), "zero", 0.0))
    return spec


def _norm(name: str, dim: int, stats: bool = True) -> list:
    spec = [(f"{name}.weight", (dim,), "one", 0.0), (f"{name}.bias", (dim,), "zero", 0.0)]
    if stats:
        spec += [(f"{name}.running_mean", (dim,), "zero", 0.0),
                 (f"{name}.running_var", (dim,), "one", 0.0)]
    return spec


def sa_widths(m: dict) -> list[int]:
    """Each SA level's output width: its radii's last widths, concatenated."""
    return [sum(mlp[-1] for mlp in level["mlps"]) for level in m["sa_plan"]]


def fp_inputs(m: dict) -> dict:
    """Each FP level's input width: fp4 joins levels 3 and 4, fp3 level 2 and fp4's output,
    fp2 level 1 and fp3's, fp1 fp2's alone."""
    w, fp = sa_widths(m), {k: v for k, v in m["fp_plan"]}
    return {"fp4": w[2] + w[3], "fp3": w[1] + fp["fp4"][-1], "fp2": w[0] + fp["fp3"][-1],
            "fp1": fp["fp2"][-1]}


def spec(m: dict) -> list:
    """The matcher's tensors at the configuration's ``model`` widths."""
    out, cin = [], 3
    for s, level in enumerate(m["sa_plan"]):
        for r, mlp in enumerate(level["mlps"]):
            c = cin + 3
            for j, ch in enumerate(mlp):
                out += _dense(f"encoder.sa{s + 1}.conv{r}_{j}", ch, c)
                out += _norm(f"encoder.sa{s + 1}.bn{r}_{j}", ch)
                c = ch
        cin = sum(mlp[-1] for mlp in level["mlps"])
    ins = fp_inputs(m)
    for name, mlp in m["fp_plan"]:
        c = ins[name]
        for j, ch in enumerate(mlp):
            out += _dense(f"encoder.{name}.conv{j}", ch, c) + _norm(f"encoder.{name}.bn{j}", ch)
            c = ch
    C, h, aff = m["pc_feat_dim"], m["tf_num_heads"], m["aff_feat_dim"]
    out += _dense("encoder.conv1", C, m["fp_plan"][-1][1][-1]) + _norm("encoder.bn1", C)
    t = "tf_self1"
    for q in ("linear_q", "linear_k", "linear_v"):
        out += _dense(f"{t}.{q}", C, C)
    out += _dense(f"{t}.linear_p0", 3, 3) + _norm(f"{t}.linear_p_bn", 3)
    out += _dense(f"{t}.linear_p1", C, 3)
    out += _norm(f"{t}.linear_w_bn0", C) + _dense(f"{t}.linear_w0", C // h, C)
    out += _norm(f"{t}.linear_w_bn1", C // h) + _dense(f"{t}.linear_w1", C // h, C // h)
    for q in ("w_qs", "w_ks", "w_vs", "fc"):
        out += _dense(f"tf_cross1.attn.{q}", C, C, bias=False)
    out += _norm("tf_cross1.attn.layer_norm", C, stats=False)
    out += _dense("tf_cross1.pos_ffn.w_1", 2 * C, C) + _dense("tf_cross1.pos_ffn.w_2", C, 2 * C)
    out += _norm("tf_cross1.pos_ffn.layer_norm", C, stats=False)
    out += _norm("cls_bn", C) + _dense("cls_head", 1 if m["cls_method"] == "binary" else 2, C)
    out += _norm("aff_bn", C) + _dense("aff_head", aff, C)
    out.append(("affinity_layer.A", (aff // 2, aff // 2), "normal",
                1.0 / math.sqrt(3.0 * (aff // 2))))
    return out


def draw(m: dict, seed: int, device, salt: int = 4) -> dict:
    """The seed's matcher weights and BatchNorm statistics on ``device``."""
    out = ref_params.draw(spec(m), seed, device, salt)
    hd = m["aff_feat_dim"] // 2
    out["affinity_layer.A"] = out["affinity_layer.A"] + torch.eye(hd, device=device)
    return out
