"""Parity of the port's geometry ops with the JAX package, on the CPU where every kernel
wrapper runs its plain PyTorch version. Each kernel's CUDA build is held against the same
plain version on the card by tests/test_torch_port_cuda.py and ``chip_smoke.py``.

Tolerances and why:
  * FPS, gather and ball-query indices: exact (same arithmetic, ties to the lowest index).
  * nn_distance: values 1e-4 (the JAX kernel test's tolerance); the JAX CPU reference uses
    the expanded x^2 - 2xy + y^2 form, so indices are compared exactly only where the
    second-best distance is more than 1e-5 away.
  * S against ``sa_stage_fused_cached(..., interpret=True)``: 1e-4.
  * M: active entries against ``masked_pairwise_nn(..., interpret=True)`` at 1e-4.
  * normals: ``lax.top_k`` and ``torch.topk`` may order equal kNN distances differently, and
    the two kNN sets come from the expanded-form distances, so normals agree up to sign to
    1e-3 on all but a few percent of points (degenerate neighbourhoods).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from puzzlefusion_plusplus_tpu.ops import chamfer as jch
from puzzlefusion_plusplus_tpu.ops import fps as jfps
from puzzlefusion_plusplus_tpu.ops import grouping as jgr
from puzzlefusion_plusplus_tpu.ops import normals as jnorm
from puzzlefusion_plusplus_tpu.ops.chamfer_pallas import masked_pairwise_nn as jmasked
from puzzlefusion_plusplus_tpu.ops.sa_fused_pallas import (
    fold_batchnorm as jfold,
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


def test_gather_and_index_points_exact():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(2, 50, 5)).astype(np.float32)
    idx = rng.integers(0, 50, size=(2, 7, 4)).astype(np.int32)
    ref = np.asarray(jgr.index_points(jnp.asarray(pts), jnp.asarray(idx)))
    np.testing.assert_array_equal(tga.gather_points(T(pts), T(idx)).numpy(), ref)
    np.testing.assert_array_equal(tgr.index_points(T(pts), T(idx).long()).numpy(), ref)


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
    tch.nn_distance(x, x)
    tfps.farthest_point_sample(x, 2)
    assert ops.launch_counts() == {k: 0 for k in "SFGNM"}
    with pytest.raises(ValueError):
        tch.nn_distance(x.to("meta"), x.to("meta"))
