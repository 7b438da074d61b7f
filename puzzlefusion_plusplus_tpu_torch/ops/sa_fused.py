"""Fused set-abstraction stages: kernels S (``csrc/sa_cached.cu``) and R
(``csrc/sa_raw.cu``) and their plain versions. Neither kernel has a backward: the frozen
encoder needs none.

Both run their matrix products on the tensor cores in 3xTF32 (each FP32 operand split into
a TF32 part and its remainder, three TF32 MMAs per product), which keeps them within 1e-6
of FP32 where one TF32 pass would miss the 1e-4 gate. Bound: those MMAs at 495 TFLOP/s.
The weights reach the kernels split: ``tf32_planes`` lays a folded weight out as its big and
small planes in the order the kernels' wgmma tail loads them. A wrapper given a plain weight
splits it on every call; the frozen encoder (``inference/sampler.py``) splits its weights
once when it is built and hands kernel S the planes (launches counted in
``presplit.launches``, "S pre-split" in ``ops.launch_counts()``). A block holds 128
(centre, neighbour) rows where they fit shared memory, else 64, and streams the weights
through a ring of bulk copies, so each weight byte read from L2 serves that many rows (see
``csrc/sa_common.cuh``).

* S replaces ``puzzlefusion_plusplus_tpu/ops/sa_fused_pallas.py::sa_stage_fused_cached``
  (``_sa_cached_kernel``). Per cloud m and centre s: h1 = relu(g_rel @ W_eff[m] +
  (feats[m] @ K_feat)[gidx] + b1), two BatchNorm-folded Dense+ReLU layers, then the max over
  the K neighbours. The per-cloud projection ``feats @ K_feat`` is a plain matmul outside the
  kernel, as in the JAX package. Its gather modes (``gather_impl``, else the env var
  ``PFPP_SA_GATHER``, default ``'onehot'``) are the JAX package's: ``'int8'`` quantizes the
  projection per cloud and column (``sa_quantize``, its own kernel) and gathers the codes
  (S's int8 instantiation, ``sa_stage_cached_int8``); every other mode is the exact gather,
  and so is ``'int8'`` on a stage without features (SA1).
* R replaces ``sa_fused_pallas.py::sa_stage_fused`` (``_sa_kernel``), the stage over a raw
  cloud ``xyz ++ feats`` and cached indices: it gathers the K neighbour rows and the centre
  row, recentres the xyz channels, and runs all three folded layers (layer 1 included)
  and the max over K in the kernel.
"""

from __future__ import annotations

import os

import torch

from puzzlefusion_plusplus_tpu_torch.ops import cuda_build


def fold_batchnorm(kernel, bias, scale, bn_bias, mean, var, eps: float = 1e-5):
    """Dense(W [in, out], b) followed by eval-mode BatchNorm -> folded (W', b')."""
    s = scale / torch.sqrt(var + eps)
    return kernel * s[None, :], (bias - mean) * s + bn_bias


def tf32_planes(w: torch.Tensor) -> torch.Tensor:
    """w [cin, cout] f32 -> its 3xTF32 planes [cin/8, 2, cout/8, 2, 8, 4] f32 (cin and cout
    multiples of 8), as the kernels' tail loads them: big = w rounded to TF32 (10 mantissa
    bits, to nearest with ties away from zero, by adding 0x1000 to the bit pattern and
    clearing the low 13 bits: ``split_tf32`` in ``csrc/sa_common.cuh``), small = w - big
    (exact), and entry [kb, p, ng, kc, n, kk] = plane p at input 8 kb + 4 kc + kk, output
    8 ng + n: per k8 slice and plane, the K-major 8 x 4 core matrices of wgmma's B operand.
    Integer arithmetic on the bit pattern and one exact subtraction, so the planes are
    bit-equal on every device."""
    cin, cout = w.shape
    bits = w.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    big = (bits + 0x1000) & 0xFFFFE000
    big = torch.where(big >= 1 << 31, big - (1 << 32), big).to(torch.int32).view(torch.float32)
    planes = torch.stack([big, w - big])  # [p, k, c] = [p, kb, kc, kk, ng, n]
    return (planes.reshape(2, cin // 8, 2, 4, cout // 8, 8).permute(1, 0, 4, 2, 5, 3)
            .contiguous())


def tf32_join(planes: torch.Tensor) -> torch.Tensor:
    """The weight [cin, cout] of ``tf32_planes``' output: big + small, exactly."""
    kb, _, ng = planes.shape[:3]
    p = planes.permute(1, 0, 3, 5, 2, 4).reshape(2, 8 * kb, 8 * ng)
    return p[0] + p[1]


def _plain(w: torch.Tensor) -> torch.Tensor:
    """A weight given plain [cin, cout] or as its planes -> plain."""
    return tf32_join(w) if w.dim() == 6 else w


def _planes(w: torch.Tensor) -> torch.Tensor:
    """A weight given plain [cin, cout] or as its planes -> planes."""
    return w.contiguous() if w.dim() == 6 else tf32_planes(w)


def _dims(w: torch.Tensor) -> tuple[int, int]:
    """(cin, cout) of a weight given plain or as its planes."""
    if w.dim() != 6:
        return tuple(w.shape)
    if w.shape[1] != 2 or tuple(w.shape[3:]) != (2, 8, 4):
        raise ValueError(f"not the planes of tf32_planes: shape {tuple(w.shape)}")
    return 8 * w.shape[0], 8 * w.shape[2]


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


def sa_quantize_plain(proj: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """proj [M, N2, C1] f32 -> (q [M, N2, C1] int8, scale [M, C1] f32), the JAX package's
    'int8' quantization (``sa_fused_pallas.py:318-323``): per cloud and column, scale =
    max(max_n |proj| / 127, 1e-30), q = clamp(round(proj / scale), -127, 127), rounding half
    to even. Both divisions are true IEEE divisions (a CUDA tensor divided by a Python
    number would be multiplied by its reciprocal), so the kernel's codes are bit-equal to
    these. They are the JAX expressions as written and as JAX computes them op by op; a
    jitted JAX caller gets the first division folded by XLA into a multiply by fl(1/127),
    a scale at most one ulp away."""
    amax = proj.abs().amax(dim=1)
    scale = torch.clamp(amax / amax.new_full((), 127.0), min=1e-30)
    q = torch.clamp(torch.round(proj / scale[:, None, :]), -127, 127).to(torch.int8)
    return q, scale


def sa_quantize(proj: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (q, scale) of ``sa_quantize_plain``; on CUDA tensors one launch of
    ``pfpp_sa_quantize`` (``csrc/sa_cached.cu``)."""
    if proj.device.type == "cpu":
        return sa_quantize_plain(proj)
    proj = proj.contiguous()
    cuda_build.require(proj, "proj", torch.float32, 3)
    M, N2, C1 = proj.shape
    q = torch.empty((M, N2, C1), dtype=torch.int8, device=proj.device)
    scale = torch.empty((M, C1), dtype=torch.float32, device=proj.device)
    cuda_build.check(
        cuda_build.function("sa_cached", "pfpp_sa_quantize")(
            proj.data_ptr(), scale.data_ptr(), q.data_ptr(), M, N2, C1,
            cuda_build.stream_ptr(proj)),
        "sa_quantize",
    )
    sa_quantize.launches += 1
    return q, scale


sa_quantize.launches = 0


def sa_gather_mode(gather_impl: str | None = None) -> str:
    """The gather mode kernel S runs: ``gather_impl``, else ``PFPP_SA_GATHER``, else
    'onehot' (``sa_fused_pallas.py:295-296``)."""
    return os.environ.get("PFPP_SA_GATHER", "onehot") if gather_impl is None else gather_impl


def _check_kernel_shapes(K: int, C1: int, C2: int, C3: int) -> None:
    """The kernels' block layout: K rows a centre inside 64-row blocks, 32-channel weight
    tiles (C1, the input of layer 2) and 64-column passes (C2, C3). Widths whose activation
    tiles exceed shared memory even at 64 rows (S: C1 + C2 above 808; R: C1 + max(Cin - 3,
    C2)) make the launch return an error."""
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
    w2: torch.Tensor, b2: torch.Tensor,  # w2, w3: [C1, C2], [C2, C3], or their tf32_planes
    w3: torch.Tensor, b3: torch.Tensor,
    gather_impl: str | None = None,  # 'onehot' | 'dynamic' (exact) | 'int8'; None reads
    # PFPP_SA_GATHER (default 'onehot'); any other string is the exact gather, as in JAX
) -> torch.Tensor:
    """-> new_feats [M, S, C3]; kernel S on CUDA tensors, which has no backward (it raises
    where autograd would need one; the plain version on CPU tensors differentiates). Under
    'int8' with ``feats`` the projection is quantized (``sa_quantize``) and gathered as
    codes (``sa_stage_cached_int8``); stage 1 has no features and runs exactly. The plain
    version takes the planes' weights back (``tf32_join``, exact)."""
    proj = None if feats is None else torch.matmul(feats, k1_feat)  # [M, N2, C1]
    on_cpu = g_rel.device.type == "cpu"
    if not on_cpu:
        cuda_build.forbid_grad("sa_stage_fused_cached", g_rel, w_eff, feats, k1_feat, b1, w2,
                               b2, w3, b3)
    if proj is not None and sa_gather_mode(gather_impl) == "int8":
        q, scale = sa_quantize(proj)
        return sa_stage_cached_int8(g_rel, w_eff, q, scale, group_idx, b1, w2, b2, w3, b3)
    if on_cpu:
        return sa_stage_plain(g_rel, w_eff, proj, group_idx, b1, _plain(w2), b2, _plain(w3), b3)
    out = _launch_s(g_rel, w_eff, proj, None, group_idx, b1, w2, b2, w3, b3)
    sa_stage_fused_cached.launches += 1
    return out


sa_stage_fused_cached.launches = 0


def sa_stage_cached_int8(g_rel, w_eff, q, scale, group_idx, b1, w2, b2, w3, b3):
    """Kernel S's 'int8' instantiation: q [M, N2, C1] int8 codes, scale [M, C1] -> [M, S, C3].
    The plain version gathers from the dequantized table q * scale and adds it after the
    xyz term, in the order of ``sa_fused_pallas.py:240``."""
    if g_rel.device.type == "cpu":
        table = q.float() * scale[:, None, :]
        return sa_stage_plain(g_rel, w_eff, table, group_idx, b1, _plain(w2), b2, _plain(w3),
                              b3)
    cuda_build.forbid_grad("sa_stage_cached_int8", g_rel, w_eff, b1, w2, b2, w3, b3)
    out = _launch_s(g_rel, w_eff, q, scale, group_idx, b1, w2, b2, w3, b3)
    sa_stage_cached_int8.launches += 1
    return out


sa_stage_cached_int8.launches = 0


class _Count:
    """A launch count kept beside a wrapper's own (``ops.launch_counts()`` reads it)."""

    launches = 0


presplit = _Count()  # launches of S, either instantiation, given W2 and W3 as planes


def _launch_s(g_rel, w_eff, proj, scale, group_idx, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Check kernel S's operands and launch it -> out [M, S, C3]: the exact instantiation
    with ``proj`` [M, N2, C1] f32 or None, or with ``scale`` [M, C1] the int8 one, ``proj``
    then holding the codes. w2 and w3 plain are split here; given as planes they count in
    ``presplit``."""
    M, S, K, _ = g_rel.shape
    (C1, C2), (C2_in, C3) = _dims(w2), _dims(w3)
    _check_kernel_shapes(K, w_eff.shape[2], C2, C3)
    given = w2.dim() == 6 and w3.dim() == 6
    g_rel, w_eff = g_rel.contiguous(), w_eff.contiguous()
    b1, b2, b3 = (t.contiguous() for t in (b1, b2, b3))
    w2, w3 = _planes(w2), _planes(w3)
    for name, t, nd in (("g_rel", g_rel, 4), ("w_eff", w_eff, 3), ("b1", b1, 1),
                        ("w2", w2, 6), ("b2", b2, 1), ("w3", w3, 6), ("b3", b3, 1)):
        cuda_build.require(t, name, torch.float32, nd,
                           align16=name in ("w_eff", "b1", "w2", "w3"))
    if w_eff.shape != (M, 3, C1) or C2_in != C2:
        raise ValueError("inconsistent layer widths")
    n2, proj_ptr, gidx_ptr = 0, None, None
    if proj is not None:
        proj = proj.contiguous()
        gidx = group_idx.to(torch.int32).contiguous()
        cuda_build.require(proj, "proj", torch.float32 if scale is None else torch.int8, 3,
                           align16=True)
        if gidx.shape != (M, S, K) or proj.shape[0] != M or proj.shape[2] != C1:
            raise ValueError("group_idx / feats do not match g_rel")
        n2, proj_ptr, gidx_ptr = proj.shape[1], proj.data_ptr(), gidx.data_ptr()
    out = torch.empty((M, S, C3), dtype=torch.float32, device=g_rel.device)
    tail = (gidx_ptr, b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
            b3.data_ptr(), out.data_ptr(), M, S, K, n2, C1, C2, C3, cuda_build.stream_ptr(g_rel))
    if scale is None:
        code = cuda_build.function("sa_cached", "pfpp_sa_cached")(
            g_rel.data_ptr(), w_eff.data_ptr(), proj_ptr, *tail)
    else:
        scale = scale.contiguous()
        cuda_build.require(scale, "scale", torch.float32, 2, align16=True)
        if proj is None or scale.shape != (M, C1):
            raise ValueError(f"the int8 kernel takes codes [M, N2, C1] and scale [M, C1]; got "
                             f"scale {tuple(scale.shape)}")
        code = cuda_build.function("sa_cached", "pfpp_sa_cached_int8")(
            g_rel.data_ptr(), w_eff.data_ptr(), proj_ptr, scale.data_ptr(), *tail)
    cuda_build.check(code, "sa_stage_fused_cached" if scale is None else "sa_stage_cached_int8")
    presplit.launches += given
    return out


def sa_stage_fused_plain(pts_cat, fps_idx, group_idx, weights) -> torch.Tensor:
    """pts_cat [M, N, Cin] (xyz ++ feats), fps_idx [M, S], group_idx [M, S, K], weights
    3 x (kernel [Cin_i, C_i], bias [C_i]) -> [M, S, C3]."""
    rows = torch.arange(pts_cat.shape[0], device=pts_cat.device)
    grouped = pts_cat[rows[:, None, None], group_idx.long()]  # [M, S, K, Cin]
    centre = pts_cat[rows[:, None], fps_idx.long()][:, :, None, :3]
    h = torch.cat([grouped[..., :3] - centre, grouped[..., 3:]], dim=-1)
    for w, b in weights:
        h = torch.relu(h @ w + b)
    return h.amax(dim=2)


def sa_stage_fused(pts_cat: torch.Tensor, fps_idx: torch.Tensor, group_idx: torch.Tensor,
                   weights) -> torch.Tensor:
    """-> new_feats [M, S, C3]; kernel R on CUDA tensors, which has no backward (it raises
    where autograd would need one; the plain version on CPU tensors differentiates).
    ``weights``: 3 x (BN-folded kernel [Cin_i, C_i], bias [C_i]). The stage's new xyz is
    ``pts_cat[..., :3]`` gathered at ``fps_idx`` (the caller's)."""
    if pts_cat.device.type == "cpu":
        return sa_stage_fused_plain(pts_cat, fps_idx, group_idx, weights)
    (w1, b1), (w2, b2), (w3, b3) = weights
    cuda_build.forbid_grad("sa_stage_fused", pts_cat, w1, b1, w2, b2, w3, b3)
    M, N, Cin = pts_cat.shape
    S, K = group_idx.shape[1], group_idx.shape[2]
    C1, C2, C3 = w1.shape[1], w2.shape[1], w3.shape[1]
    _check_kernel_shapes(K, C1, C2, C3)
    if (Cin - 3) % 32 or C1 % 64:
        raise ValueError(f"kernel R takes Cin - 3 % 32 == 0 and C1 % 64 == 0; got Cin={Cin}, "
                         f"C1={C1}")
    pts_cat = pts_cat.contiguous()
    w1, b1, w2, b2, w3, b3 = (t.contiguous() for t in (w1, b1, w2, b2, w3, b3))
    fidx = fps_idx.to(torch.int32).contiguous()
    gidx = group_idx.to(torch.int32).contiguous()
    cuda_build.require(pts_cat, "pts_cat", torch.float32, 3)
    for name, t, nd in (("w1", w1, 2), ("b1", b1, 1), ("w2", w2, 2), ("b2", b2, 1),
                        ("w3", w3, 2), ("b3", b3, 1)):
        cuda_build.require(t, name, torch.float32, nd, align16=name in ("w1", "b1", "w2", "w3"))
    if (w1.shape[0] != Cin or w2.shape[0] != C1 or w3.shape[0] != C2 or b1.shape != (C1,)
            or b2.shape != (C2,) or b3.shape != (C3,)):
        raise ValueError("inconsistent layer widths")
    if fidx.shape != (M, S) or gidx.shape != (M, S, K) or fidx.device != pts_cat.device:
        raise ValueError("fps_idx / group_idx do not match pts_cat")
    w1f = tf32_planes(w1[3:]) if Cin > 3 else None
    w2p, w3p = tf32_planes(w2), tf32_planes(w3)
    out = torch.empty((M, S, C3), dtype=torch.float32, device=pts_cat.device)
    cuda_build.check(
        cuda_build.library("sa_raw").pfpp_sa_raw(
            pts_cat.data_ptr(), fidx.data_ptr(), gidx.data_ptr(), w1.data_ptr(),
            None if w1f is None else w1f.data_ptr(), b1.data_ptr(), w2p.data_ptr(),
            b2.data_ptr(), w3p.data_ptr(), b3.data_ptr(), out.data_ptr(), M, N, Cin, S, K, C1,
            C2, C3, cuda_build.stream_ptr(pts_cat)),
        "sa_stage_fused",
    )
    sa_stage_fused.launches += 1
    return out


sa_stage_fused.launches = 0
