"""Parity of the port's geometry ops with the JAX package, on the CPU where every kernel
wrapper runs its plain PyTorch version. Each kernel's CUDA build is held against the same
plain version on the card by tests/test_torch_port_cuda.py and ``chip_smoke.py``.

Tolerances and why:
  * FPS, gather and ball-query indices: exact (same arithmetic, ties to the lowest index).
  * nn_distance: values 1e-4 (the JAX kernel test's tolerance); the JAX CPU reference uses
    the expanded x^2 - 2xy + y^2 form, so indices are compared exactly only where the
    second-best distance is more than 1e-5 away.
  * S against ``sa_stage_fused_cached(..., interpret=True)``: 1e-4.
  * R (``sa_stage_fused``'s plain version) against the Pallas ``sa_stage_fused`` in interpret
    mode: 1e-4 relative to the largest output (FP32 sums in another order; the Pallas
    gathers are exact byte-plane one-hot matmuls).
  * P (``farthest_point_sample_per_cloud``) against the Pallas
    ``farthest_point_sample_pallas`` in interpret mode: indices exact, masked and unmasked,
    wherever a cloud has a valid point. A cloud with none differs on purpose: the Pallas
    kernel starts at its padded length, an index outside the cloud, where the port (and
    ``farthest_point_sample_xla``, the JAX package's dispatcher off the TPU) starts at 0.
  * M: active entries against ``masked_pairwise_nn(..., interpret=True)`` at 1e-4.
  * The 3xTF32 split that S and R run on the tensor cores, emulated in numpy on one
    SA3-width layer: within 1e-5 of float64 (relative to the largest output), where a
    single TF32 product misses the kernels' 1e-4 gate.
  * The weights' split (``tf32_planes``): bit for bit against a numpy model of the rule
    written in float64 arithmetic (round to 10 mantissa bits, ties away from zero), on
    finite values: ties, subnormals, signed zeros; the planes' layout round-trips exactly.
  * normals: ``lax.top_k`` and ``torch.topk`` may order equal kNN distances differently, and
    the two kNN sets come from the expanded-form distances, so normals agree up to sign to
    1e-3 on all but a few percent of points (degenerate neighbourhoods).
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from puzzlefusion_plusplus_tpu.ops import chamfer as jch
from puzzlefusion_plusplus_tpu.ops import fps as jfps
from puzzlefusion_plusplus_tpu.ops import grouping as jgr
from puzzlefusion_plusplus_tpu.ops import normals as jnorm
from puzzlefusion_plusplus_tpu.ops.chamfer_pallas import masked_pairwise_nn as jmasked
from puzzlefusion_plusplus_tpu.ops.sa_fused_pallas import (
    fold_batchnorm as jfold,
    sa_stage_fused as jsa_raw,
    sa_stage_fused_cached as jsa,
)
from puzzlefusion_plusplus_tpu_torch import ops
from puzzlefusion_plusplus_tpu_torch.ops import chamfer as tch
from puzzlefusion_plusplus_tpu_torch.ops import fps as tfps
from puzzlefusion_plusplus_tpu_torch.ops import gather as tga
from puzzlefusion_plusplus_tpu_torch.ops import grouping as tgr
from puzzlefusion_plusplus_tpu_torch.ops import normals as tnorm
from puzzlefusion_plusplus_tpu_torch.ops import sa_fused as tsa

torch.set_num_threads(2)


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("masked", [False, True])
def test_fps_indices_exact(masked):
    rng = np.random.default_rng(0)
    B, N, npoint = 3, 200, 48
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((B, N)) < 0.5
        mask[0, :10] = False  # start is the first VALID point
        mask[2] = False  # no valid point at all
        mask[2, 150:160] = True
    ref = np.asarray(jfps.farthest_point_sample_xla(
        jnp.asarray(xyz), npoint, None if mask is None else jnp.asarray(mask)))
    out = tfps.farthest_point_sample(T(xyz), npoint, None if mask is None else T(mask))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("masked", [False, True])
def test_fps_per_cloud_matches_pallas_interpret(pallas_interpret, masked):
    rng = np.random.default_rng(10)
    B, N, npoint = 3, 300, 40  # N not a multiple of the Pallas kernel's 128 lanes
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((B, N)) < 0.5
        mask[0, :10] = False  # start is the first VALID point
        mask[2] = False
        mask[2, 150:160] = True  # fewer valid points than selections
    ref = np.asarray(jfps.farthest_point_sample_pallas(
        jnp.asarray(xyz), npoint, None if mask is None else jnp.asarray(mask)))
    out = tfps.farthest_point_sample_per_cloud(T(xyz), npoint,
                                               None if mask is None else T(mask))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        tfps.farthest_point_sample_per_cloud_plain(T(xyz), npoint,
                                                   None if mask is None else T(mask)).numpy(),
        ref)


def _fps_edge_inputs(case, B=3, N=260):
    rng = np.random.default_rng(21)
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    mask = rng.random((B, N)) < 0.5
    if case == "duplicates":  # valid points at distance 0 of a chosen one against invalid ones
        xyz[:, N // 2:] = xyz[:, : N - N // 2]
        mask[1] = False
        mask[1, 10:20] = mask[1, N // 2 + 10: N // 2 + 20] = True
    elif case == "few_valid":  # fewer valid points than selections
        mask[:] = False
        mask[:, 7:12] = True
    else:  # no valid point: index 0 throughout
        mask[:] = False
    return xyz, mask


@pytest.mark.parametrize("case", ["duplicates", "few_valid", "all_invalid"])
def test_fps_edge_cases_match_jax(pallas_interpret, case):
    """The cases kernels F and P must get right, through both wrappers on the CPU, against
    the JAX package's FPS (and its Pallas kernel where the two agree: with no valid point
    the Pallas kernel starts at the padded length, see ROADMAP's 'not faults')."""
    xyz, mask = _fps_edge_inputs(case)
    npoint = 40
    ref = np.asarray(jfps.farthest_point_sample_xla(jnp.asarray(xyz), npoint, jnp.asarray(mask)))
    if case != "all_invalid":
        np.testing.assert_array_equal(ref, np.asarray(jfps.farthest_point_sample_pallas(
            jnp.asarray(xyz), npoint, jnp.asarray(mask))))
    else:
        assert not ref.any()
    for fn in (tfps.farthest_point_sample, tfps.farthest_point_sample_per_cloud):
        np.testing.assert_array_equal(fn(T(xyz), npoint, T(mask)).numpy(), ref)


def _orderable(v):
    """csrc/fps.cu's orderable: the total-order map of float32 onto uint32."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u >> 31, ~u & 0xFFFFFFFF, u | 0x80000000)


def test_fps_key_is_argmax_with_lowest_index_ties():
    """The kernels' key orderable(dist) << 32 | (0xFFFFFFFF - index): its unsigned max is the
    plain version's argmax, a valid point at distance 0 beats an invalid one at -1e10, and a
    slot without a point (key 0) loses to both."""
    rng = np.random.default_rng(3)
    for _ in range(50):
        d = rng.choice(np.float32([-1e10, 0.0, 0.5, 1e10, 2.0, 1e-30]), size=37)
        d[rng.random(37) < 0.3] = rng.random() * 4
        key = (_orderable(d) << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - np.arange(37,
                                                                                    dtype=np.uint64))
        assert int(np.argmax(key)) == int(np.argmax(d))
    assert _orderable(np.float32(0.0)) > _orderable(np.float32(-1e10)) > 0
    assert _orderable(np.float32(-np.inf)) > 0


@pytest.mark.parametrize("kernel", ["F", "P"])
def test_fps_block_shapes_fit_the_kernels(kernel):
    """The shapes the wrappers hand the launch are ones it runs: whole warps, at most 512
    threads a register tier (1024 streaming), every point of a slice owned, clusters of 1, 2,
    4 or 8, and registers for every slice of up to 8192 points."""
    for n in list(range(1, 600)) + [1000, 1024, 2047, 2048, 2049, 4096, 4097, 8000, 8192, 8193,
                                    12000, 16384, 16385, 20000, tfps.P_MAX_POINTS]:
        cl, ppt, threads = (1, *tfps.block_shape(n)) if kernel == "F" else tfps.cluster_shape(n)
        slice_ = -(-n // cl)
        assert cl in (1, 2, 4, 8)
        assert threads % 32 == 0 and threads >= 32
        if ppt:
            assert ppt in tfps.REG_TIERS and threads <= tfps.REG_MAX_THREADS
            assert threads * ppt >= slice_ > threads * ppt - 32 * ppt  # no idle warp
        else:
            assert threads <= tfps.STREAM_THREADS and slice_ > tfps.REG_MAX_POINTS
        if kernel == "P" and n <= 8 * tfps.REG_MAX_POINTS:
            assert ppt > 0
        assert (cl, ppt, threads) in tfps.launch_shapes(n, (cl,))  # one that chip_smoke times


def _raw_sa_inputs(rng, M, N, Cin, S, K, widths):
    pts = rng.standard_normal((M, N, Cin)).astype(np.float32)
    fidx = rng.integers(0, N, size=(M, S)).astype(np.int32)
    gidx = rng.integers(0, N, size=(M, S, K)).astype(np.int32)
    weights, cin = [], Cin
    for c in widths:
        weights.append((rng.standard_normal((cin, c)).astype(np.float32) * cin ** -0.5,
                        rng.standard_normal(c).astype(np.float32) * 0.1))
        cin = c
    return pts, fidx, gidx, weights


@pytest.mark.parametrize("stage", ["xyz_only", "feats"])
def test_sa_stage_fused_matches_pallas_interpret(pallas_interpret, stage):
    """R's plain version (what every CPU path runs) against the Pallas kernel it replaces;
    both gather the centre row and recentre only the xyz channels."""
    rng = np.random.default_rng(11)
    Cin = 3 if stage == "xyz_only" else 3 + 32
    pts, fidx, gidx, weights = _raw_sa_inputs(rng, 2, 40, Cin, 12, 8, (64, 64, 128))
    ref = np.asarray(jsa_raw(jnp.asarray(pts), jnp.asarray(fidx), jnp.asarray(gidx),
                             [(jnp.asarray(w), jnp.asarray(b)) for w, b in weights]))
    out = tsa.sa_stage_fused(T(pts), T(fidx), T(gidx), [(T(w), T(b)) for w, b in weights])
    assert out.shape == (2, 12, 128)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_gather_and_index_points_exact():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(2, 50, 5)).astype(np.float32)
    idx = rng.integers(0, 50, size=(2, 7, 4)).astype(np.int32)
    ref = np.asarray(jgr.index_points(jnp.asarray(pts), jnp.asarray(idx)))
    np.testing.assert_array_equal(tga.gather_points(T(pts), T(idx)).numpy(), ref)
    np.testing.assert_array_equal(tgr.index_points(T(pts), T(idx).long()).numpy(), ref)
    p = T(pts).requires_grad_()
    with torch.no_grad():  # the path without autograd gives the same values
        fast = tga.gather_points(p, T(idx))
    assert fast.grad_fn is None and tga.gather_points(p, T(idx)).grad_fn is not None
    np.testing.assert_array_equal(fast.numpy(), ref)


@pytest.mark.parametrize("C,offset_floats,width", [
    (3, 0, 1), (4, 0, 4), (33, 0, 1), (128, 0, 4), (256, 0, 4), (128, 1, 1), (128, 4, 4),
])
def test_gather_unit_width_follows_row_width_and_alignment(C, offset_floats, width):
    """Kernel G moves float4s only when a row is whole float4s and the source is 16-byte
    aligned; a view at an odd storage offset takes one-float units."""
    assert tga.gather_width(C, 256 + 4 * offset_floats) == width


@pytest.mark.parametrize("R,C,n,fused", [
    (1000, 3, 1000, True),       # the chamfer loss's target side: one launch
    (2048, 4, 1000, True),       # 8192 floats
    (2731, 3, 1000, False),      # 8193 floats: two launches
    (64, 128, 10, True),         # wide rows, few of them
    (8192, 128, 256, False),     # SA2's backward
    (100, 3, 57511, True),       # n counts, two copies of g and a counter: 58112 words
    (100, 3, 57512, False),
])
def test_scatter_route_and_scratch(R, C, n, fused):
    """Kernel B runs in one launch (no scratch) when a cloud's g is small and fits shared
    memory beside the counts, else in two through scratch: the lists and row pointers."""
    assert tga.scatter_fused(R, C, n) == fused
    assert tga.scatter_scratch_ints(3, R, n, C) == (0 if fused else 3 * (R + n + 1))


def test_square_distance_and_ball_query_exact():
    rng = np.random.default_rng(2)
    for B, N, S, K, r in ((2, 333, 64, 16, 0.25), (1, 200, 32, 8, 5.0), (2, 100, 8, 8, 0.01)):
        x = (rng.normal(size=(B, N, 3)) * 0.3).astype(np.float32)
        c = x[:, :S]
        np.testing.assert_allclose(
            tgr.square_distance(T(c), T(x)).numpy(),
            np.asarray(jgr.square_distance(jnp.asarray(c), jnp.asarray(x))), atol=1e-5)
        ref = np.asarray(jgr.query_ball_point(r, K, jnp.asarray(x), jnp.asarray(c)))
        out = tgr.query_ball_point(r, K, T(x), T(c))
        np.testing.assert_array_equal(out.numpy(), ref)


def test_knn_points():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 100, 3)).astype(np.float32)
    jd, ji = jgr.knn_points(jnp.asarray(x), jnp.asarray(x), 8)
    td, ti = tgr.knn_points(T(x), T(x), 8)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    # continuous random points: no exact distance ties, so the neighbour order agrees
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_nn_distance_and_chamfer():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 300, 3)).astype(np.float32)
    y = rng.normal(size=(2, 257, 3)).astype(np.float32)
    jd, ji = jch.nn_distance(jnp.asarray(x), jnp.asarray(y))
    td, ti = tch.nn_distance(T(x), T(y))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    d_all = ((x[:, :, None] - y[:, None]) ** 2).sum(-1)
    part = np.sort(d_all, axis=-1)
    clear = part[..., 1] - part[..., 0] > 1e-5
    np.testing.assert_array_equal(ti.numpy()[clear], np.asarray(ji)[clear])
    np.testing.assert_array_equal(ti.numpy(), d_all.argmin(-1))  # exact vs float64 argmin
    np.testing.assert_allclose(
        tch.chamfer_distance_mean(T(x), T(y)).numpy(),
        np.asarray(jch.chamfer_distance_mean(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5)


def test_nn_distance_plain_chunks_queries(monkeypatch):
    """The plain version bounds its [chunk, M] distance block; results do not depend on it."""
    rng = np.random.default_rng(5)
    x, y = (T(rng.normal(size=(2, 100, 3)).astype(np.float32)) for _ in range(2))
    full = tch.nn_distance_plain(x, y)
    monkeypatch.setattr(tch, "_CHUNK_ELEMS", 2 * 100 * 7)  # 7 queries per chunk
    chunked = tch.nn_distance_plain(x, y)
    for a, b in zip(full, chunked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("M", [100, 1500])  # one 1024-point tile of the kernel, then two
def test_nn_distance_plain_ties_go_to_the_lowest_index(M):
    """The tie rule kernel N's chunk rescan keeps: with exact duplicates, some 32 and some
    512 points apart (other chunks and tiles), and queries on duplicated targets, the plain
    version's distances equal numpy's in the kernels' order and its indices numpy's
    first-index argmin."""
    rng = np.random.default_rng(M)
    y = rng.normal(size=(2, M, 3)).astype(np.float32)
    for gap in (g for g in (1, 32, 512, M // 2) if g < M):
        src = rng.integers(0, M - gap, size=M // 8)
        y[:, src + gap] = y[:, src]
    x = np.concatenate([rng.normal(size=(2, 50, 3)).astype(np.float32), y[:, ::7]], 1)
    diff = x[:, :, None] - y[:, None]
    d = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    td, ti = tch.nn_distance_plain(T(x), T(y))
    np.testing.assert_array_equal(td.numpy(), d.min(-1))
    np.testing.assert_array_equal(ti.numpy(), d.argmin(-1))
    ties = (d == d.min(-1, keepdims=True)).sum(-1) > 1
    assert ties.sum() > 10  # the rule is exercised


def test_masked_pairwise_nn_matches_pallas_interpret():
    rng = np.random.default_rng(6)
    P, N = 4, 300  # N not a tile multiple
    pts = (rng.normal(size=(P, N, 3)) * 0.3).astype(np.float32)
    mask = np.zeros((P, P), bool)
    mask[0, 1] = mask[1, 0] = mask[2, 3] = True
    ref = np.asarray(jmasked(jnp.asarray(pts), jnp.asarray(mask), interpret=True))
    out = tch.masked_pairwise_nn(T(pts)[None], T(mask)[None])[0].numpy()
    np.testing.assert_allclose(out[mask], ref[mask], atol=1e-4)
    assert (out[~mask] == tch.INACTIVE).all()


def _sa_inputs(rng, M, S, K, N2, D, C1, C2, C3):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    feats = f(M, N2, D) if D else None
    gidx = rng.integers(0, N2, size=(M, S, K)).astype(np.int32) if D else None
    k1f = f(D, C1) * D ** -0.5 if D else None
    return (f(M, S, K, 3), f(M, 3, C1), feats, gidx, k1f, f(C1), f(C1, C2) * C1 ** -0.5,
            f(C2), f(C2, C3) * C2 ** -0.5, f(C3))


@pytest.mark.parametrize("stage", ["no_feats", "feats"])
def test_sa_stage_matches_pallas_interpret(stage):
    rng = np.random.default_rng(7)
    D = 0 if stage == "no_feats" else 8
    args = _sa_inputs(rng, 2, 12, 8, 24, D, 32, 64, 64)
    ref = np.asarray(jsa(*(None if a is None else jnp.asarray(a) for a in args),
                         interpret=True))
    out = tsa.sa_stage_fused_cached(*(None if a is None else T(a) for a in args))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_fold_batchnorm():
    rng = np.random.default_rng(8)
    k, b, s, bb, m = (rng.normal(size=sh).astype(np.float32)
                      for sh in ((5, 4), (4,), (4,), (4,), (4,)))
    v = rng.uniform(0.5, 2.0, size=4).astype(np.float32)
    jk, jb = jfold(k, b, s, bb, m, v)
    tk, tb = tsa.fold_batchnorm(*map(T, (k, b, s, bb, m, v)))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["analytic", "lowmem"])
def test_normals(method):
    rng = np.random.default_rng(9)
    pcs = rng.normal(size=(2, 200, 3)).astype(np.float32) * np.array([1.0, 1.0, 0.2],
                                                                        np.float32)
    ref = np.asarray(jnorm.estimate_pointcloud_normals(jnp.asarray(pcs), 20, method=method))
    out = tnorm.estimate_pointcloud_normals(T(pcs), 20, method=method).numpy()
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)
    agree = np.abs(out - ref).max(-1) < 1e-3
    assert agree.mean() > 0.97, agree.mean()


def test_wrappers_use_plain_version_only_on_cpu():
    """On the CPU no launch is counted; any other device must launch the kernel or raise."""
    ops.reset_launch_counts()
    x = torch.zeros(1, 4, 3)
    idx = torch.zeros((1, 2), dtype=torch.int32)
    tch.nn_distance(x, x)
    tfps.farthest_point_sample(x, 2)
    tga.gather_points_approx(x, idx)
    tga.scatter_add(x[:, :2], idx, 4)
    tsa.sa_quantize(x)
    assert ops.launch_counts() == {k: 0 for k in [*"SFGNMABRPD", "S int8", "S int8 quantize",
                                                  "S pre-split"]}
    with pytest.raises(ValueError):
        tsa.sa_quantize(x.to("meta"))
    with pytest.raises(ValueError):
        tch.nn_distance(x.to("meta"), x.to("meta"))
    with pytest.raises(ValueError):
        tga.gather_points_approx(x.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError):
        tga.scatter_add(x[:, :2].to("meta"), idx.to("meta"), 4)


def test_kernels_without_backward_refuse_grad_off_the_cpu():
    """S, M and R have no backward: off the CPU they raise where autograd would need one
    (and before anything is built); on the CPU their plain versions differentiate."""
    pts = torch.randn((1, 2, 5, 3), requires_grad=True)
    pm = torch.ones((1, 2, 2), dtype=torch.bool)
    tch.masked_pairwise_nn(pts, pm).sum().backward()
    assert pts.grad is not None
    with pytest.raises(RuntimeError, match="no backward"):
        tch.masked_pairwise_nn(pts.detach().to("meta").requires_grad_(), pm.to("meta"))
    args = [torch.randn(s) for s in ((1, 4, 8, 3), (1, 3, 64), (64,), (64, 64), (64,),
                                     (64, 64), (64,))]
    args[3].requires_grad_()
    tsa.sa_stage_fused_cached(args[0], args[1], None, None, None, *args[2:]).sum().backward()
    assert args[3].grad is not None
    meta = [a.detach().to("meta") for a in args]
    meta[3].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tsa.sa_stage_fused_cached(meta[0], meta[1], None, None, None, *meta[2:])
    with torch.no_grad(), pytest.raises(ValueError):  # past the guard: not a CUDA tensor
        tsa.sa_stage_fused_cached(meta[0], meta[1], None, None, None, *meta[2:])

    rng = np.random.default_rng(12)
    pts, fidx, gidx, weights = _raw_sa_inputs(rng, 1, 20, 35, 4, 8, (64, 64, 128))
    w = [(T(a).requires_grad_(), T(b)) for a, b in weights]
    tsa.sa_stage_fused(T(pts), T(fidx), T(gidx), w).sum().backward()
    assert w[0][0].grad is not None
    meta_w = [(a.detach().to("meta").requires_grad_(), b.to("meta")) for a, b in w]
    with pytest.raises(RuntimeError, match="no backward"):
        tsa.sa_stage_fused(T(pts).to("meta"), T(fidx).to("meta"), T(gidx).to("meta"), meta_w)
    with torch.no_grad(), pytest.raises(ValueError):  # past the guard: not a CUDA tensor
        tsa.sa_stage_fused(T(pts).to("meta"), T(fidx).to("meta"), T(gidx).to("meta"), meta_w)
    with pytest.raises(ValueError, match="1 to"):  # P's resident-cloud limit
        tfps.farthest_point_sample_per_cloud(torch.zeros((1, tfps.P_MAX_POINTS + 1, 3),
                                                         device="meta"), 4)


def _tf32(x, round_nearest: bool):
    """x rounded to TF32 (10 mantissa bits) as the kernels do it: to nearest, ties away from
    zero (sa_common.cuh's split), or truncated (what the tensor core keeps of an operand)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    if round_nearest:
        u = u + np.uint32(0x1000)
    return (u & np.uint32(0xffffe000)).view(np.float32)


def test_3xtf32_split_keeps_fp32_accuracy_where_tf32_does_not():
    """The precision argument of kernels S and R: x = big + small with big = tf32(x) and
    small = x - big (truncated by the tensor core), and x @ w as small@big + big@small +
    big@big. Products of TF32 values are exact in float64; the kernels sum them in float32,
    8 input channels at a time (one m16n8k8 MMA), which the second emulation follows."""
    rng = np.random.default_rng(21)
    x = np.maximum(rng.standard_normal((64, 256)), 0).astype(np.float32)  # ReLU inputs
    w = (rng.standard_normal((256, 512)) * 256 ** -0.5).astype(np.float32)
    f64 = lambda a: a.astype(np.float64)  # noqa: E731
    ref = f64(x) @ f64(w)
    scale = np.abs(ref).max()
    xb, wb = _tf32(x, True), _tf32(w, True)
    xs, ws = _tf32(x - xb, False), _tf32(w - wb, False)
    assert np.array_equal(f64(xb) + f64(x - xb), f64(x))  # the split is exact
    single = f64(xb) @ f64(wb)
    pairs = ((xs, wb), (xb, ws), (xb, wb))
    summed = sum((f64(a) @ f64(b)).astype(np.float32) for a, b in pairs)
    acc = np.zeros(ref.shape, np.float32)
    for k in range(0, 256, 8):
        for a, b in pairs:
            acc = acc + (f64(a[:, k:k + 8]) @ f64(b[k:k + 8])).astype(np.float32)
    err = lambda y: np.abs(f64(y) - ref).max() / scale  # noqa: E731
    assert err(single) > 1e-4, err(single)
    assert err(summed) < 1e-5, err(summed)
    assert err(acc) < 1e-5, err(acc)


def _tf32_model(x: np.ndarray) -> np.ndarray:
    """float32 x -> TF32 x in float64 arithmetic: |x| to the nearest multiple of its TF32 ulp
    (2^(e - 10) for a leading bit 2^e, e at least -126 as float32's subnormals have), ties
    away from zero, the sign kept (signed zeros too)."""
    a = np.abs(x.astype(np.float64))
    lead = np.maximum(np.frexp(a)[1] - 1, -126)
    ulp = np.ldexp(1.0, lead - 10)
    return np.copysign(np.floor(a / ulp + 0.5) * ulp, x.astype(np.float64)).astype(np.float32)


def _split_cases(case: str) -> np.ndarray:
    rng = np.random.default_rng(31)
    if case == "normal":
        return (rng.standard_normal(256) * 10.0 ** rng.integers(-30, 30, 256)).astype(np.float32)
    if case == "ties":  # the low 13 bits exactly half an ulp, and one bit either side
        hi = rng.integers(0x00800000 >> 13, 0x7f000000 >> 13, 256, dtype=np.int64) << 13
        low = np.resize(np.array([0x1000, 0x0fff, 0x1001, 0x1fff], np.int64), 256)
        sign = np.resize(np.array([0, 1 << 31], np.int64), 256)
        return ((hi | low | sign).astype(np.uint32)).view(np.float32)
    if case == "subnormal":
        mant = rng.integers(1, 1 << 23, 252, dtype=np.int64)
        mant[:4] = [0x1000, 0x7ff000, 0x7fffff, 0x0fff]  # a tie, the carry into the normals
        sign = np.resize(np.array([0, 1 << 31], np.int64), 256)
        return ((np.concatenate([mant, [1, 2, 0x1001, 0x3000]]) | sign)
                .astype(np.uint32)).view(np.float32)
    vals = np.zeros(256, np.float32)  # signed zeros among small and ordinary values
    vals[1::2] = -0.0
    vals[::8] = np.float32(1e-40)
    vals[3::8] = np.float32(-3.5)
    return vals


@pytest.mark.parametrize("case", ["normal", "ties", "subnormal", "signed_zero"])
def test_tf32_planes_split_by_the_kernels_rule(case):
    """``tf32_planes`` (the weights' split, once per frozen encoder) against the numpy model:
    big bit-equal to the model, small = x - big exactly, big + small == x, and each value at
    its place in the planes' layout [cin/8, 2, cout/8, 2, 8, 4]."""
    x = _split_cases(case)
    assert np.all(np.isfinite(x))
    w = x.reshape(16, 16)
    planes = tsa.tf32_planes(torch.from_numpy(w.copy())).numpy()
    assert planes.shape == (2, 2, 2, 2, 8, 4)
    k, c = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    at = lambda p: planes[k // 8, p, c // 8, (k % 8) // 4, c % 8, k % 4]  # noqa: E731
    big, small = at(0), at(1)
    model = _tf32_model(w)
    assert np.array_equal(big.view(np.uint32), model.view(np.uint32))
    assert np.array_equal((big.view(np.uint32) & 0x1fff), np.zeros_like(big, np.uint32))
    assert np.array_equal(small.view(np.uint32), (w - model).view(np.uint32))
    assert np.array_equal(big.astype(np.float64) + small, w.astype(np.float64))
    assert np.array_equal(big + small, w)


def test_tf32_planes_round_trip_and_kernel_s_takes_them():
    """``tf32_join`` gives the weight back bit for bit, and S's wrapper given the planes
    computes what it computes from the plain weights (its plain version on the CPU)."""
    rng = np.random.default_rng(32)
    w = rng.standard_normal((64, 128)).astype(np.float32)
    planes = tsa.tf32_planes(T(w))
    assert planes.shape == (8, 2, 16, 2, 8, 4) and planes.is_contiguous()
    assert np.array_equal(tsa.tf32_join(planes).numpy().view(np.uint32), w.view(np.uint32))
    M, S, K, N2, D, C1, C2, C3 = 2, 5, 8, 12, 16, 32, 64, 128
    r = lambda *s: T(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    args = [r(M, S, K, 3), r(M, 3, C1), r(M, N2, D), T(rng.integers(0, N2, (M, S, K))),
            r(D, C1), r(C1), r(C1, C2), r(C2), r(C2, C3), r(C3)]
    split = list(args)
    split[6], split[8] = tsa.tf32_planes(args[6]), tsa.tf32_planes(args[8])
    assert torch.equal(tsa.sa_stage_fused_cached(*args), tsa.sa_stage_fused_cached(*split))
