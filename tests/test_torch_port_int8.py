"""Kernel S's int8 gather mode (``PFPP_SA_GATHER=int8``) against the JAX package's, on the
CPU, where the port's wrappers run their plain versions and the JAX kernel runs in Pallas
interpret mode.

Under 'int8' both packages quantize each cloud's projection ``proj = feats @ K_feat`` per
column (scale = max(max_n |proj| / 127, 1e-30), q = round-half-even(proj / scale) clamped to
+-127) and add q * scale in place of the gathered row. The codes are compared where the
projection is the same in both frameworks (``K_feat = I``: proj = feats exactly); with a
random ``K_feat`` the two matmuls differ in the last ulp, which may move a code by one
quantum. The port divides by 127 as the JAX source is written and as JAX computes it op by
op; under ``jit`` XLA folds the division by the constant into a multiply by fl(1/127),
which moves a scale by at most one ulp (about 4.5% of random columns) and a code only where
proj / scale lies within an ulp of a half.

Tolerances and why:
  * K_feat = I: codes and scales equal to the formula's op-by-op result (under jit: scales
    within one ulp, codes equal in at least 99.9% of entries); S's output within 2e-4 (S's
    exact-path tolerance in tests/test_ops.py, FP32 sums in another order).
  * random K_feat: JAX's own bound for the int8 mode (tests/test_ops.py:286-293), one
    quantum step through the two folded layers, step * |w2|_1 * |w3|_1 + 2e-4; codes agree
    in at least 99.9% of entries.
  * discriminating: the port's int8 output is at least 10x nearer to JAX's int8 output than
    the port's exact output is (the check fails if the port ignores the mode).
  * the frozen cached encode of a small VQ-VAE: z_e within 1e-4 of its largest entry and
    codes equal in at least 95% of tokens (an int8 step moves z_e by up to a quantum, so a
    codebook argmin within that of a tie may flip on one side alone).
  * the engine under int8 with the JAX engine's noise replayed: the tolerances of
    tests/test_torch_port_engine.py (iterations and merged pairs exact, trajectories 1e-3).
    Its damped denoiser (contractive, so that the two frameworks' runs stay comparable)
    hardly reads the latents, so the engine test shows that the int8 encode ran in every
    step (the quantize calls), and the encode test above, not the trajectories, tells int8
    from exact.
  * the per-shape ``auto_agglomerate``: 1e-5 against its own ``auto_agglomerate_batch`` row
    and against the JAX ``auto_agglomerate``, as tests/test_inference_e2e.py holds the JAX
    batch engine against the vmapped per-shape one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puzzlefusion_plusplus_tpu.ops import sa_fused_pallas as jsf
from puzzlefusion_plusplus_tpu_torch.ops import sa_fused as tsa

torch.set_num_threads(2)

M, S, K, N2, C1, C2, C3 = 3, 16, 32, 40, 32, 32, 64


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def jax_codes(proj):
    """The JAX package's quantization, the expressions of sa_fused_pallas.py:318-323."""
    s = jnp.max(jnp.abs(proj), axis=1, keepdims=True) / 127.0
    scale = jnp.maximum(s, 1e-30)
    return jnp.clip(jnp.round(proj / scale), -127, 127).astype(jnp.int8), scale[:, 0]


def stage_inputs(seed, identity=False, zero_col=None):
    """One SA stage with features: (g, w_eff, feats, gidx, k1f, b1, w2, b2, w3, b3)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    D = C1 if identity else 24
    feats = np.maximum(f(M, N2, D), 0)
    k1f = np.eye(D, dtype=np.float32) if identity else f(D, C1) * D ** -0.5
    if zero_col is not None:
        feats[:, :, zero_col] = 0
        if not identity:
            k1f[:, zero_col] = 0
    gidx = rng.integers(0, N2, size=(M, S, K)).astype(np.int32)
    return (0.1 * f(M, S, K, 3), f(M, 3, C1) * 3 ** -0.5, feats, gidx, k1f, 0.1 * f(C1),
            f(C1, C2) * C1 ** -0.5, 0.1 * f(C2), f(C2, C3) * C2 ** -0.5, 0.1 * f(C3))


def run_jax(args, gather_impl="int8"):
    return np.asarray(jsf.sa_stage_fused_cached(
        *(None if a is None else jnp.asarray(a) for a in args), interpret=True,
        gather_impl=gather_impl))


def run_port(args, gather_impl="int8"):
    return tsa.sa_stage_fused_cached(*(None if a is None else T(a) for a in args),
                                     gather_impl=gather_impl).numpy()


def test_codes_and_output_equal_jax_where_the_projection_is_exact():
    args = stage_inputs(0, identity=True)
    proj = T(args[2]) @ T(args[4])
    np.testing.assert_array_equal(proj.numpy(), args[2])  # K_feat = I: proj = feats exactly
    q, scale = tsa.sa_quantize_plain(proj)
    jq, js = jax_codes(jnp.asarray(args[2]))  # as written: true divisions
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    # under jit XLA folds "/ 127.0" into a multiply by fl(1/127): scales within one ulp
    jq, js = jax.jit(jax_codes)(jnp.asarray(args[2]))
    np.testing.assert_allclose(scale.numpy(), np.asarray(js), rtol=1.2e-7, atol=0)
    assert (q.numpy() == np.asarray(jq)).mean() >= 0.999
    np.testing.assert_allclose(run_port(args), run_jax(args), rtol=0, atol=2e-4)


def test_random_weights_within_jax_bound():
    args = stage_inputs(1)
    out, ref = run_port(args), run_jax(args)
    proj = args[2] @ args[4]
    step = (np.abs(proj).max(axis=1) / 254.0).max()
    tol = step * np.abs(args[6]).sum(0).max() * np.abs(args[8]).sum(0).max() + 2e-4
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)
    q, _ = tsa.sa_quantize_plain(T(args[2]) @ T(args[4]))
    jq, _ = jax_codes(jnp.einsum("mnd,dc->mnc", jnp.asarray(args[2]), jnp.asarray(args[4])))
    assert (q.numpy() == np.asarray(jq)).mean() >= 0.999


@pytest.mark.parametrize("identity", [True, False])
def test_int8_is_nearer_to_jax_int8_than_the_exact_path(identity):
    args = stage_inputs(2, identity=identity)
    ref = run_jax(args)
    err_int8 = np.abs(run_port(args) - ref).max()
    err_exact = np.abs(run_port(args, "onehot") - ref).max()
    assert err_exact > 0 and err_int8 * 10 <= err_exact, (err_int8, err_exact)


def test_stage_one_has_no_features_and_runs_exactly():
    args = stage_inputs(3)
    args = args[:2] + (None, None, None) + args[5:]
    np.testing.assert_array_equal(run_port(args, "int8"), run_port(args, "onehot"))
    np.testing.assert_allclose(run_port(args, "int8"), run_jax(args, "int8"), atol=2e-4)


@pytest.mark.parametrize("mode", ["dynamic", "no_such_mode"])
def test_other_modes_are_the_exact_gather(mode):
    args = stage_inputs(4)
    np.testing.assert_array_equal(run_port(args, mode), run_port(args, "onehot"))
    np.testing.assert_allclose(run_port(args, mode), run_jax(args, "onehot"), atol=2e-4)


def test_env_var_picks_the_mode_when_none_is_given(monkeypatch):
    args = stage_inputs(5)
    monkeypatch.setenv("PFPP_SA_GATHER", "int8")
    assert tsa.sa_gather_mode() == "int8" and tsa.sa_gather_mode("onehot") == "onehot"
    np.testing.assert_array_equal(run_port(args, None), run_port(args, "int8"))
    monkeypatch.delenv("PFPP_SA_GATHER")
    assert tsa.sa_gather_mode() == "onehot"
    np.testing.assert_array_equal(run_port(args, None), run_port(args, "onehot"))


@pytest.mark.parametrize("identity", [True, False])
def test_all_zero_column(identity):
    args = stage_inputs(6, identity=identity, zero_col=5)
    q, scale = tsa.sa_quantize_plain(T(args[2]) @ T(args[4]))
    assert torch.all(q[:, :, 5] == 0) and torch.all(scale[:, 5] == np.float32(1e-30))
    out = run_port(args)
    assert np.isfinite(out).all()
    if identity:
        np.testing.assert_allclose(out, run_jax(args), rtol=0, atol=2e-4)


def test_int8_wrappers_match_their_plain_versions_on_the_cpu():
    args = [T(a) for a in stage_inputs(7)]
    proj = args[2] @ args[4]
    q, scale = tsa.sa_quantize(proj)
    q2, s2 = tsa.sa_quantize_plain(proj)
    assert torch.equal(q, q2) and torch.equal(scale, s2)
    out = tsa.sa_stage_cached_int8(args[0], args[1], q, scale, args[3], *args[5:])
    table = q.float() * scale[:, None, :]
    ref = tsa.sa_stage_plain(args[0], args[1], table, args[3], *args[5:])
    assert torch.equal(out, ref)


# ------------------------------------------------------------------ the frozen encoder


@pytest.fixture
def jax_s_outputs(monkeypatch):
    """The JAX package's kernel S in interpret mode on the CPU wherever its encodes call it
    (``_make_fused_cached_encode`` imports it at each call); each output is recorded."""
    outputs, orig = [], jsf.sa_stage_fused_cached

    def interpreted(*args, **kwargs):
        outputs.append(orig(*args, **{**kwargs, "interpret": True}))
        return outputs[-1]

    monkeypatch.setattr(jsf, "sa_stage_fused_cached", interpreted)
    return outputs


def _small_vqvae():
    from tests.helpers import jit_init

    from puzzlefusion_plusplus_tpu.models.vqvae import VQVAE as JVQ
    from puzzlefusion_plusplus_tpu_torch.convert import from_jax
    from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE as TVQ

    vq = JVQ(n_embeddings=32, embedding_dim=16, num_point=25, num_dim=64,
             sa_npoints=(24, 12), sa_nsamples=(8, 8, 8), remat=False)
    vv = jax.device_get(jit_init(vq, jax.random.key(0), jnp.zeros((1, 96, 3)), train=False))
    tvq = TVQ(32, 16, 25, 64, sa_npoints=(24, 12), sa_nsamples=(8, 8, 8))
    tvq.load_state_dict(from_jax.vqvae_state_dict(vv["params"], vv["batch_stats"]))
    return vq, vv, tvq.eval()


def test_make_frozen_encoder_reads_the_env_var_once(monkeypatch):
    from puzzlefusion_plusplus_tpu_torch.inference.sampler import make_frozen_encoder

    _, _, tvq = _small_vqvae()
    monkeypatch.setenv("PFPP_SA_GATHER", "int8")
    enc = make_frozen_encoder(tvq)
    assert enc.sa_gather == "int8" and make_frozen_encoder(tvq, "cached", "onehot").sa_gather \
        == "onehot"
    monkeypatch.delenv("PFPP_SA_GATHER")
    assert make_frozen_encoder(tvq).sa_gather == "onehot"
    quantized = []
    monkeypatch.setattr(tsa, "sa_quantize", functools.partial(
        lambda f, p: quantized.append(p.shape) or f(p), tsa.sa_quantize))
    rng = np.random.default_rng(8)
    flat = T(rng.standard_normal((4, 96, 3)).astype(np.float32))
    rot = torch.linalg.qr(T(rng.standard_normal((4, 3, 3)).astype(np.float32)))[0]
    idx, geom = enc.grouping(flat)
    enc.apply(flat, idx, geom, rot)  # the variable is gone: the mode read at build holds
    assert quantized == [(4, 24, 128), (4, 12, 256)]  # SA2 and SA3


def test_cached_encode_matches_the_jax_fused_cached_encode_under_int8(monkeypatch,
                                                                       jax_s_outputs):
    from puzzlefusion_plusplus_tpu.inference.sampler import _make_fused_cached_encode
    from puzzlefusion_plusplus_tpu.models.vqvae import pn2_grouping_geometry as jgroup
    from puzzlefusion_plusplus_tpu_torch.inference.sampler import make_frozen_encoder

    vq, vv, tvq = _small_vqvae()
    rng = np.random.default_rng(9)
    flat = rng.standard_normal((8, 96, 3)).astype(np.float32) * 0.3
    q = rng.standard_normal((8, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    from puzzlefusion_plusplus_tpu_torch.utils.transforms import quat_to_matrix

    rot = quat_to_matrix(T(q))
    # the JAX encode, z_e recovered from its last stage's output (the encode returns z_q)
    monkeypatch.setenv("PFPP_SA_GATHER", "int8")
    jenc = _make_fused_cached_encode(vq, vv["params"], vv["batch_stats"])
    jidx, jgeom = jgroup(jnp.asarray(flat), 25, (24, 12), (8, 8, 8))
    jout = jenc(jidx, jgeom, jnp.asarray(rot.numpy()))
    p = vv["params"]["pn2"]
    jz_e = np.asarray(jax_s_outputs[-1] @ p["conv6"]["kernel"] + p["conv6"]["bias"])
    monkeypatch.delenv("PFPP_SA_GATHER")

    tenc = make_frozen_encoder(tvq, gather_impl="int8")
    idx, geom = tenc.grouping(T(flat))
    for (ji, jg), (ti, tg) in zip(jidx, idx):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    out = tenc.apply(T(flat), idx, geom, rot)
    exact = make_frozen_encoder(tvq, gather_impl="onehot").apply(T(flat), idx, geom, rot)
    scale = np.abs(jz_e).max()
    err = np.abs(out["z_e"].numpy() - jz_e).max()
    assert err <= 1e-4 * scale, err / scale
    assert np.abs(exact["z_e"].numpy() - jz_e).max() >= 10 * err  # int8, not exact
    codes = (out["z_q"].numpy() == np.asarray(jout["z_q"])).all(-1).mean()
    assert codes >= 0.95, codes
    np.testing.assert_allclose(out["xyz"].numpy(), np.asarray(jout["xyz"]), atol=1e-5)


# ------------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def engine_setup(tmp_path_factory):
    """The small engine of tests/test_torch_port_engine.py, with the JAX encoder running
    its fused cached encode (the path the JAX package takes on a TPU) in interpret mode."""
    from tests.helpers import jit_init

    from puzzlefusion_plusplus_tpu.data import generate_dataset
    from puzzlefusion_plusplus_tpu.data.datasets import DenoiserDataset
    from puzzlefusion_plusplus_tpu.data.loader import Loader
    from puzzlefusion_plusplus_tpu.inference.sampler import make_frozen_encoder
    from puzzlefusion_plusplus_tpu.models.denoiser import DenoiserTransformer as JDen
    from puzzlefusion_plusplus_tpu.models.verifier import VerifierTransformer as JVer
    from puzzlefusion_plusplus_tpu_torch.convert import from_jax
    from puzzlefusion_plusplus_tpu_torch.models.denoiser import DenoiserTransformer as TDen
    from puzzlefusion_plusplus_tpu_torch.models.verifier import VerifierTransformer as TVer

    root = str(tmp_path_factory.mktemp("port_int8_engine"))
    generate_dataset(root, num_shapes=2, seed=5, split="val", min_parts=3, max_parts=4,
                     n_points=96)
    ds = DenoiserDataset(root + "/pc_data/val", mode="test",
                         matching_data_path=root + "/matching_data", max_num_part=4,
                         max_corr=32, max_edges_dense=12)
    batch = next(iter(Loader(ds, 2, shuffle=False, drop_last=False)))
    B, P = batch["part_valids"].shape
    vq, vv, tvq = _small_vqvae()
    den = JDen(embed_dim=32, num_layers=1, num_heads=2, num_dim=64, num_point=25,
               max_parts=P, num_ada_embeds=1000)
    ver = JVer(embed_dim=32, num_layers=1, num_heads=2, max_nodes=20, ff_dim=64)
    E = P * (P - 1) // 2
    dp = jit_init(den, jax.random.key(1), jnp.zeros((1, P, 7)), jnp.zeros((1,), jnp.int32),
                  jnp.zeros((1, P, 25, 64)), jnp.zeros((1, P, 25, 3)), jnp.ones((1, P)),
                  jnp.ones((1, P, 1)), jnp.zeros((1, P), bool), train=False)["params"]
    vp = jit_init(ver, jax.random.key(2), jnp.zeros((1, E, 7)), jnp.zeros((1, E, 2), jnp.int32),
                  jnp.ones((1, E)), train=False)["params"]
    # damped weights: a contractive recurrence (tests/test_bucketing.py)
    dp = jax.device_get(jax.tree.map(lambda x: 0.05 * x, dp))
    vp = jax.device_get(jax.tree.map(lambda x: 0.05 * x, vp))
    composable = make_frozen_encoder(vq, vv["params"], vv["batch_stats"])
    jax_side = dict(
        vq=vq, vv=vv, composable=composable,
        dapply=lambda *a: den.apply({"params": dp}, *a, train=False),
        vapply=lambda *a: ver.apply({"params": vp}, *a, train=False),
    )
    tden = TDen(32, 1, 2, 64, max_parts=P, num_ada_embeds=1000)
    tden.load_state_dict(from_jax.denoiser_state_dict(dp))
    tver = TVer(32, 1, 2, max_nodes=20, ff_dim=64)
    tver.load_state_dict(from_jax.verifier_state_dict(vp))
    return batch, jax_side, dict(vq=tvq, den=tden.eval(), ver=tver.eval())


def _jax_int8_encoder(js):
    """The JAX frozen encoder with its cached calls on the fused cached encode (kernel S),
    which it takes on a TPU; PFPP_SA_GATHER is read when the engine is traced."""
    from puzzlefusion_plusplus_tpu.inference.sampler import _make_fused_cached_encode

    fused = _make_fused_cached_encode(js["vq"], js["vv"]["params"], js["vv"]["batch_stats"])
    comp = js["composable"]

    def apply(flat_pcs, cached_idx=None, cached_geom=None, rot=None):
        if cached_geom is not None and rot is not None:
            return fused(cached_idx, cached_geom, rot)
        return comp.apply(flat_pcs, cached_idx, cached_geom, rot)

    return comp._replace(apply=apply)


def _replay_noise(rngs, P, n_steps):
    """The JAX engine's key schedule: one split for the initial noise, one per step."""
    from puzzlefusion_plusplus_tpu.inference import engine as JE

    init, steps = [], []
    for key in rngs:
        key, k = jax.random.split(key)
        init.append(JE._per_part_normal(k, P))
        row = []
        for _ in range(n_steps):
            key, k = jax.random.split(key)
            row.append(JE._per_part_normal(k, P))
        steps.append(jnp.stack(row))
    return T(np.stack(init)), T(np.stack(steps).transpose(1, 0, 2, 3))


def _small_cfg(batch):
    from puzzlefusion_plusplus_tpu_torch.utils.config import Config

    cfg = Config()
    cfg.verifier.max_iters, cfg.verifier.threshold = 2, 0.0
    cfg.data.max_num_part = batch["part_valids"].shape[1]
    cfg.inference.batch_size = batch["part_valids"].shape[0]
    return cfg


def test_engine_under_int8_matches_the_jax_engine_under_int8(engine_setup, monkeypatch,
                                                             jax_s_outputs):
    from puzzlefusion_plusplus_tpu.inference import engine as JE
    from puzzlefusion_plusplus_tpu.models.scheduler import DDPMParams as JDDPM
    from puzzlefusion_plusplus_tpu_torch.inference import run as R

    batch, js, ps = engine_setup
    batch = dict(batch, ref_part=np.zeros_like(batch["ref_part"]))  # forced merges
    rngs = jax.random.split(jax.random.key(7), 2)
    sample = {k: jnp.asarray(batch[k]) for k in R.SAMPLE_KEYS}
    monkeypatch.setenv("PFPP_SA_GATHER", "int8")
    jout = jax.device_get(jax.jit(lambda s, r: JE.auto_agglomerate_batch(
        js["dapply"], js["vapply"], _jax_int8_encoder(js), JDDPM.piecewise(), s, r,
        JE.AgglConfig(max_iters=2, threshold=0.0)))(sample, rngs))

    quantized = []
    monkeypatch.setattr(tsa, "sa_quantize", functools.partial(
        lambda f, p: quantized.append(p.shape) or f(p), tsa.sa_quantize))
    cfg = _small_cfg(batch)
    engine = R.build_engine_fn(cfg, "cpu", models=(ps["vq"], ps["den"], ps["ver"]))
    monkeypatch.delenv("PFPP_SA_GATHER")  # read once, when the engine was built
    assert engine.sa_gather == "int8"
    P = batch["part_valids"].shape[1]
    tout = engine(batch, noise=_replay_noise(rngs, P, 2 * 20))
    assert len(quantized) == 2 * 20 * int(jout["n_iters"])  # SA2 and SA3 of every step
    jfs = jout["final_state"]
    assert np.asarray(jfs.adj).any(), "merges never fired"
    np.testing.assert_array_equal(tout["n_iters"], np.full(2, int(jout["n_iters"])))
    np.testing.assert_array_equal(tout["n_merged_pairs"],
                                  np.asarray(jfs.adj).sum((-1, -2)) // 2)
    np.testing.assert_allclose(tout["trajectory"], np.asarray(jout["trajectory"]), atol=1e-3)



def test_run_inference_under_int8(engine_setup, monkeypatch, tmp_path):
    from puzzlefusion_plusplus_tpu_torch.data.synthetic import generate_dataset
    from puzzlefusion_plusplus_tpu_torch.inference import run as R

    batch, _, ps = engine_setup
    generate_dataset(str(tmp_path), num_shapes=2, seed=5, split="val", min_parts=3,
                     max_parts=4, n_points=96)
    cfg = _small_cfg(batch)
    cfg.data.data_val_dir = str(tmp_path / "pc_data" / "val")
    cfg.data.matching_data_path = str(tmp_path / "matching_data")
    cfg.trainer.output_dir = str(tmp_path / "out")
    cfg.inference.save_trajectories = False
    quantized = []
    monkeypatch.setattr(tsa, "sa_quantize", functools.partial(
        lambda f, p: quantized.append(p.shape) or f(p), tsa.sa_quantize))
    monkeypatch.setenv("PFPP_SA_GATHER", "int8")
    engine = R.build_engine_fn(cfg, "cpu", models=(ps["vq"], ps["den"], ps["ver"]))
    agg = R.run_inference(cfg, engine=engine)
    assert quantized and agg["num_samples"] == 2
    assert all(np.isfinite(agg[f"eval/{k}"]) for k in ("part_acc", "shape_cd", "rmse_r",
                                                         "rmse_t"))


# ------------------------------------------------------------------ per-shape engine


def test_auto_agglomerate_per_shape(engine_setup):
    from puzzlefusion_plusplus_tpu.inference import auto_agglomerate as jauto
    from puzzlefusion_plusplus_tpu.models.scheduler import DDPMParams as JDDPM
    from puzzlefusion_plusplus_tpu_torch import inference as TI
    from puzzlefusion_plusplus_tpu_torch.inference.run import SAMPLE_KEYS
    from puzzlefusion_plusplus_tpu_torch.models.scheduler import DDPMParams as TDDPM

    batch, js, ps = engine_setup
    batch = dict(batch, ref_part=np.zeros_like(batch["ref_part"]))  # forced merges
    jcfg = TI.AgglConfig(max_iters=2, threshold=0.0)
    rngs = jax.random.split(jax.random.key(11), 2)
    P = batch["part_valids"].shape[1]
    init, steps = _replay_noise(rngs, P, 2 * 20)
    enc = TI.make_frozen_encoder(ps["vq"])
    tbatch = {k: T(batch[k]) for k in SAMPLE_KEYS}
    with torch.no_grad():
        rows = TI.auto_agglomerate_batch(ps["den"], ps["ver"], enc, TDDPM.piecewise(),
                                         tbatch, jcfg, noise=(init, steps))
    for b in range(2):
        sample = {k: v[b] for k, v in tbatch.items()}
        with torch.no_grad():
            one = TI.auto_agglomerate(ps["den"], ps["ver"], enc, TDDPM.piecewise(), sample,
                                      jcfg, noise=(init[b], steps[:, b]))
        jone = jax.device_get(jax.jit(lambda s, r: jauto(
            js["dapply"], js["vapply"], js["composable"], JDDPM.piecewise(), s, r,
            jcfg))({k: jnp.asarray(batch[k][b]) for k in SAMPLE_KEYS}, rngs[b]))
        assert one["trajectory"].shape == (2 * 20, P, 7)
        for k in ("pred_trans", "pred_rots", "trajectory"):
            np.testing.assert_allclose(one[k].numpy(), rows[k][b].numpy(), atol=1e-5,
                                       err_msg=k)
            np.testing.assert_allclose(one[k].numpy(), np.asarray(jone[k]), atol=1e-5,
                                       err_msg=k)
        for k in ("pivot", "part_valids", "classified", "adj", "node_valids"):
            np.testing.assert_array_equal(getattr(one["final_state"], k).numpy(),
                                          getattr(rows["final_state"], k)[b].numpy())
            np.testing.assert_array_equal(getattr(one["final_state"], k).numpy(),
                                          np.asarray(getattr(jone["final_state"], k)))
