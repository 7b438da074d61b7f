"""Fused set-abstraction stage over cached geometry: kernel S (``csrc/sa_cached.cu``) and
its plain version.

Replaces ``puzzlefusion_plusplus_tpu/ops/sa_fused_pallas.py::sa_stage_fused_cached``
(``_sa_cached_kernel``) with its ``'onehot'`` semantics, an exact gather. Per cloud m and
centre s: h1 = relu(g_rel @ W_eff[m] + (feats[m] @ K_feat)[gidx] + b1), two BatchNorm-folded
Dense+ReLU layers, then the max over the K neighbours. The per-cloud projection
``feats @ K_feat`` is a plain matmul outside the kernel, as in the JAX package. Bound: FP32
operations on the CUDA cores (see the source note).
"""

from __future__ import annotations

import torch

from puzzlefusion_plusplus_tpu_torch.ops import cuda_build


def fold_batchnorm(kernel, bias, scale, bn_bias, mean, var, eps: float = 1e-5):
    """Dense(W [in, out], b) followed by eval-mode BatchNorm -> folded (W', b')."""
    s = scale / torch.sqrt(var + eps)
    return kernel * s[None, :], (bias - mean) * s + bn_bias


def sa_stage_plain(g_rel, w_eff, proj, group_idx, b1, w2, b2, w3, b3) -> torch.Tensor:
    """g_rel [M, S, K, 3], w_eff [M, 3, C1], proj [M, N2, C1] or None, group_idx [M, S, K]
    -> [M, S, C3]."""
    h = torch.einsum("mskd,mdc->mskc", g_rel, w_eff)
    if proj is not None:
        rows = torch.arange(proj.shape[0], device=proj.device)[:, None, None]
        h = h + proj[rows, group_idx.long()]
    h = torch.relu(h + b1)
    h = torch.relu(h @ w2 + b2)
    h = torch.relu(h @ w3 + b3)
    return h.amax(dim=2)


def _check_kernel_shapes(K: int, C1: int, C2: int, C3: int) -> None:
    if 64 % K or K % 4 or C1 % 32 or C2 % 64 or C3 % 64:
        raise ValueError(
            f"kernel S takes K dividing 64 and a multiple of 4, C1 % 32 == 0, C2 % 64 == 0, "
            f"C3 % 64 == 0; got K={K}, C=({C1}, {C2}, {C3})"
        )


def sa_stage_fused_cached(
    g_rel: torch.Tensor,  # [M, S, K, 3] cached grouped relative xyz (unrotated)
    w_eff: torch.Tensor,  # [M, 3, C1] rotation- and BN-folded conv0 xyz weights
    feats: torch.Tensor | None,  # [M, N2, D] previous-stage features (None for stage 1)
    group_idx: torch.Tensor | None,  # [M, S, K] (None for stage 1)
    k1_feat: torch.Tensor | None,  # [D, C1] BN-folded conv0 feature weights
    b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    w3: torch.Tensor, b3: torch.Tensor,
) -> torch.Tensor:
    """-> new_feats [M, S, C3]; kernel S on CUDA tensors."""
    proj = None if feats is None else torch.matmul(feats, k1_feat)  # [M, N2, C1]
    if g_rel.device.type == "cpu":
        return sa_stage_plain(g_rel, w_eff, proj, group_idx, b1, w2, b2, w3, b3)
    M, S, K, _ = g_rel.shape
    C1, C2, C3 = w_eff.shape[2], w2.shape[1], w3.shape[1]
    _check_kernel_shapes(K, C1, C2, C3)
    g_rel, w_eff = g_rel.contiguous(), w_eff.contiguous()
    b1, w2, b2, w3, b3 = (t.contiguous() for t in (b1, w2, b2, w3, b3))
    for name, t, nd in (("g_rel", g_rel, 4), ("w_eff", w_eff, 3), ("b1", b1, 1),
                        ("w2", w2, 2), ("b2", b2, 1), ("w3", w3, 2), ("b3", b3, 1)):
        cuda_build.require(t, name, torch.float32, nd, align16=name in ("w2", "w3"))
    if w_eff.shape != (M, 3, C1) or w2.shape[0] != C1 or w3.shape[0] != C2:
        raise ValueError("inconsistent layer widths")
    n2, proj_ptr, gidx_ptr = 0, None, None
    if proj is not None:
        proj = proj.contiguous()
        gidx = group_idx.to(torch.int32).contiguous()
        cuda_build.require(proj, "proj", torch.float32, 3)
        if gidx.shape != (M, S, K) or proj.shape[0] != M or proj.shape[2] != C1:
            raise ValueError("group_idx / feats do not match g_rel")
        n2, proj_ptr, gidx_ptr = proj.shape[1], proj.data_ptr(), gidx.data_ptr()
    out = torch.empty((M, S, C3), dtype=torch.float32, device=g_rel.device)
    lib = cuda_build.library("sa_cached")
    cuda_build.check(
        lib.pfpp_sa_cached(g_rel.data_ptr(), w_eff.data_ptr(), proj_ptr, gidx_ptr,
                           b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
                           b3.data_ptr(), out.data_ptr(), M, S, K, n2, C1, C2, C3,
                           cuda_build.stream_ptr(g_rel)),
        "sa_stage_fused_cached",
    )
    sa_stage_fused_cached.launches += 1
    return out


sa_stage_fused_cached.launches = 0
