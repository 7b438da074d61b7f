"""Parity of the port's pure-math modules with the JAX package: transforms, masking, the DDPM
scheduler, embeddings and metrics. The same seeded numpy inputs go to both functions.

Tolerances: float32 elementwise math 1e-5 (rounding order differs between XLA and torch);
integer/bool outputs exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from puzzlefusion_plusplus_tpu.models import embeddings as jemb
from puzzlefusion_plusplus_tpu.models import scheduler as jsch
from puzzlefusion_plusplus_tpu.utils import masking as jmask
from puzzlefusion_plusplus_tpu.utils import metrics as jmet
from puzzlefusion_plusplus_tpu.utils import transforms as jtf
from puzzlefusion_plusplus_tpu_torch.models import embeddings as temb
from puzzlefusion_plusplus_tpu_torch.models import scheduler as tsch
from puzzlefusion_plusplus_tpu_torch.utils import masking as tmask
from puzzlefusion_plusplus_tpu_torch.utils import metrics as tmet
from puzzlefusion_plusplus_tpu_torch.utils import transforms as ttf

torch.set_num_threads(2)


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _quats(rng, shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    q[..., 0] += 1.5  # non-unit, away from zero
    return q


@pytest.mark.parametrize("name", ["quat_normalize", "quat_to_matrix", "quat_to_euler",
                                  "matrix_to_quat"])
def test_unary_quaternion_ops(name):
    rng = np.random.default_rng(0)
    q = _quats(rng, (3, 5))
    if name == "matrix_to_quat":
        x = np.asarray(jtf.quat_to_matrix(jtf.quat_normalize(jnp.asarray(q))))
    else:
        x = q
    ref = np.asarray(getattr(jtf, name)(jnp.asarray(x)))
    out = getattr(ttf, name)(T(x)).numpy()
    atol = 5e-4 if name == "quat_to_euler" else 1e-5  # degrees
    np.testing.assert_allclose(out, ref, atol=atol, rtol=1e-5)


@pytest.mark.parametrize("name", ["quat_apply_raw", "qrot"])
def test_rotations_of_points(name):
    rng = np.random.default_rng(1)
    q = _quats(rng, (4,))
    v = rng.normal(size=(4, 7, 3)).astype(np.float32)
    if name == "qrot":
        q = np.asarray(jtf.quat_normalize(jnp.asarray(q)))
        args = (q, v)
    else:  # deliberately NOT normalized: scales by |q|^2
        args = (q[:, None, :], v)
    ref = np.asarray(getattr(jtf, name)(*map(jnp.asarray, args)))
    out = getattr(ttf, name)(*map(T, args)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-5)


def test_transform_pc_and_affine_roundtrip():
    rng = np.random.default_rng(2)
    t = rng.normal(size=(2, 3, 3)).astype(np.float32)
    q = np.asarray(jtf.quat_normalize(jnp.asarray(_quats(rng, (2, 3)))))
    pc = rng.normal(size=(2, 3, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ttf.transform_pc(T(t), T(q), T(pc)).numpy(),
        np.asarray(jtf.transform_pc(jnp.asarray(t), jnp.asarray(q), jnp.asarray(pc))),
        atol=1e-5)
    aff = ttf.pose_to_affine(T(t), T(q))
    np.testing.assert_allclose(aff.numpy(), np.asarray(jtf.pose_to_affine(t, q)), atol=1e-6)
    tr, qr = ttf.affine_to_pose(aff)
    jtr, jqr = jtf.affine_to_pose(jnp.asarray(aff.numpy()))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jtr), atol=1e-6)
    np.testing.assert_allclose(qr.numpy(), np.asarray(jqr), atol=1e-5)


def test_masking_compaction_roundtrip():
    rng = np.random.default_rng(3)
    valids = (rng.random((4, 6)) < 0.6).astype(np.float32)
    valids[0] = 0  # no valid part at all
    valids[1] = 1
    jo, js, jv = jmask.compaction_indices(jnp.asarray(valids))
    to, ts, tv = tmask.compaction_indices(T(valids))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    x = rng.normal(size=(4, 6, 5, 3)).astype(np.float32)
    comp = tmask.compact_parts(T(x), ts)
    np.testing.assert_array_equal(comp.numpy(), np.asarray(jmask.compact_parts(x, js)))
    back = tmask.scatter_parts(comp, to, tv)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jmask.scatter_parts(
        jnp.asarray(comp.numpy()), jo, jv)))


def test_scheduler_tables_and_steps():
    np.testing.assert_array_equal(tsch.piecewise_betas(), jsch.piecewise_betas())
    np.testing.assert_array_equal(tsch.leading_timesteps(1000, 20),
                                  jsch.leading_timesteps(1000, 20))
    tp, jp = tsch.DDPMParams.piecewise(), jsch.DDPMParams.piecewise()
    np.testing.assert_array_equal(tp.alphas_cumprod, np.asarray(jp.alphas_cumprod))
    rng = np.random.default_rng(4)
    for t in tsch.leading_timesteps(1000, 20).tolist():  # includes t = 0 (no variance)
        x, eps, z = (rng.normal(size=(2, 3, 7)).astype(np.float32) for _ in range(3))
        ref = np.asarray(jsch.step(jp, jnp.asarray(eps), t, jnp.asarray(x), jnp.asarray(z), 20))
        out = tsch.step(tp, T(eps), t, T(x), T(z), 20).numpy()
        # 1/sqrt(abar) reaches ~180 at t=950: float32 rounding scales with it
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)


def test_embeddings():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 7)).astype(np.float32)
    np.testing.assert_allclose(temb.nerf_embed(T(x)).numpy(),
                               np.asarray(jemb.nerf_embed(jnp.asarray(x))), atol=1e-5)
    np.testing.assert_array_equal(temb.sinusoidal_table(20, 64), jemb.sinusoidal_table(20, 64))


def test_pose_metrics():
    rng = np.random.default_rng(6)
    t1, t2 = (rng.normal(size=(3, 5, 3)).astype(np.float32) for _ in range(2))
    r1, r2 = _quats(rng, (3, 5)), _quats(rng, (3, 5))
    valids = (rng.random((3, 5)) < 0.7).astype(np.float32)
    valids[:, 0] = 1
    for metric in ("mse", "rmse", "mae"):
        np.testing.assert_allclose(
            tmet.trans_metrics(T(t1), T(t2), T(valids), metric).numpy(),
            np.asarray(jmet.trans_metrics(t1, t2, valids, metric)), rtol=1e-5)
        np.testing.assert_allclose(
            tmet.rot_metrics(T(r1), T(r2), T(valids), metric).numpy(),
            np.asarray(jmet.rot_metrics(r1, r2, valids, metric)), rtol=1e-4, atol=1e-3)
    nan = np.array([[np.nan, 1.0]], np.float32)
    assert tmet.valid_mean(T(nan), torch.ones(1, 2)).item() == 0.5  # NaN zeroed


def test_part_acc_and_shape_cd():
    """calc_part_acc / calc_shape_cd with the 1e3 padding of invalid parts. The JAX CPU
    reference computes chamfer in the expanded x^2 - 2xy + y^2 form, whose cancellation
    error near the 1e3-padded points (|x|^2 ~ 3e6) is ~0.3 in absolute terms; the port uses
    direct differences. Padded points match each other exactly in both (distance ~0), so
    the comparison stays at rtol 1e-4 with atol 1e-3 for the shape CD."""
    rng = np.random.default_rng(7)
    B, P, N = 2, 4, 64
    pts = rng.normal(size=(B, P, N, 3)).astype(np.float32) * 0.3
    t1 = rng.normal(size=(B, P, 3)).astype(np.float32) * 0.05
    t2 = t1 + rng.normal(size=(B, P, 3)).astype(np.float32) * 0.05
    r1 = np.asarray(jtf.quat_normalize(jnp.asarray(_quats(rng, (B, P)))))
    r2 = np.asarray(jtf.quat_normalize(jnp.asarray(r1 + 0.05 * rng.normal(size=r1.shape))))
    valids = np.ones((B, P), np.float32)
    valids[1, 3] = 0
    args = (pts, t1, t2, r1, r2.astype(np.float32), valids)
    jacc, jper, jcd = jmet.calc_part_acc(*map(jnp.asarray, args))
    tacc, tper, tcd = tmet.calc_part_acc(*map(T, args))
    np.testing.assert_allclose(tcd.numpy(), np.asarray(jcd), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(tper.numpy(), np.asarray(jper))
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(tmet.calc_shape_cd(*map(T, args)).numpy(),
                               np.asarray(jmet.calc_shape_cd(*map(jnp.asarray, args))),
                               rtol=1e-4, atol=1e-3)
