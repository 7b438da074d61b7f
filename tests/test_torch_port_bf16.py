"""``trainer.precision=bf16`` in the port against the JAX package's bf16 models, on the CPU.

The JAX package builds the denoiser and clones the frozen encoder with ``dtype=bfloat16``
(flax's per-module casts, parameters fp32). The port mirrors those casts module by module
(``models/denoiser.py``, ``models/vqvae.py``), including where XLA computes a bf16 op in fp32
because its result is promoted at once. Tolerances and why:
  * one AdaLayerNorm and one attention block: within 1e-6 of the JAX block's largest output
    (the attention is bit-equal; the LayerNorm's statistics sum in another order), while
    the port's fp32 block is 1e-4 or more away from JAX's bf16 one;
  * the whole denoiser forward: a 1e-7 difference in fp32 (a LayerNorm, a GEMM summing in
    another order) flips the bf16 rounding of a few activations, and attention spreads a
    flip over its shape, so the outputs are held by share: at least 30% of them within 1e-5
    of the largest output (74% on these inputs), where the port in fp32 gets at most 5%
    (0.7%), and all within 2e-2 (0.28% here; bf16's own error is about 1e-2);
  * the composable encode (``VQVAE.with_dtype`` against ``ae.clone(dtype=bfloat16)``): z_e
    within 5e-3 of its largest entry with at least 99% of its entries within 1e-5, and at
    least 99% of the code indices equal (all are, on these inputs);
  * one training step: loss 2e-3 relative (1.9e-4 here), each gradient within 5e-2 in
    relative L2 norm (up to 3.6e-2 here: the flips above, in backward), the limits of
    ``training/parity.py::BF16``; the parameters and AdamW's state stay fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import jit_init

import puzzlefusion_plusplus_tpu.models.denoiser as JD
from puzzlefusion_plusplus_tpu.inference import sampler as jsampler
from puzzlefusion_plusplus_tpu.models import scheduler as jsched
from puzzlefusion_plusplus_tpu.models.vqvae import VQVAE as JVQ
from puzzlefusion_plusplus_tpu.training import denoiser as jtrain
from puzzlefusion_plusplus_tpu_torch.convert import from_jax
from puzzlefusion_plusplus_tpu_torch.inference import run as R
from puzzlefusion_plusplus_tpu_torch.inference import sampler as tsampler
from puzzlefusion_plusplus_tpu_torch.models import scheduler as tsched
from puzzlefusion_plusplus_tpu_torch.models.denoiser import DenoiserTransformer as TDen
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE as TVQ
from puzzlefusion_plusplus_tpu_torch.training import denoiser as ttrain
from puzzlefusion_plusplus_tpu_torch.training import state as tstate

torch.set_num_threads(2)
BF16 = jnp.bfloat16
E, NL, H, L = 32, 2, 2, 25
VQ_KW = dict(n_embeddings=32, embedding_dim=16, num_point=25, num_dim=64,
             sa_npoints=(24, 12), sa_nsamples=(8, 8, 8))


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _inputs(rng, B, P):
    return (rng.normal(size=(B, P, 7)).astype(np.float32),
            rng.integers(0, 1000, B),
            rng.normal(size=(B, P, L, 64)).astype(np.float32),
            (rng.normal(size=(B, P, L, 3)) * 0.3).astype(np.float32),
            (np.arange(P)[None] < rng.integers(2, P + 1, (B, 1))).astype(np.float32),
            rng.uniform(0.2, 1, (B, P, 1)).astype(np.float32),
            np.eye(P, dtype=bool)[rng.integers(0, 2, B)])


@pytest.fixture(scope="module")
def den():
    """A small JAX denoiser's params (AdaLN tables of 1000 rows), and 32 shapes of 4 parts."""
    rng = np.random.default_rng(0)
    B, P = 32, 4
    args = _inputs(rng, B, P)
    jden = JD.DenoiserTransformer(embed_dim=E, num_layers=NL, num_heads=H, num_dim=64,
                                  num_point=L, max_parts=P, num_ada_embeds=1000, dropout=0.0,
                                  pe_dropout=0.0)
    params = _np_tree(jit_init(jden, jax.random.key(1), *[jnp.asarray(a) for a in args],
                               train=False)["params"])
    return dict(jden=jden, params=params, args=args, P=P)


def _port_den(params, P, dtype):
    m = TDen(E, NL, H, 64, max_parts=P, num_ada_embeds=1000, dropout=0.0, pe_dropout=0.0,
             dtype=dtype)
    m.load_state_dict(from_jax.denoiser_state_dict(params))
    return m.eval()


def _rel(out, ref) -> np.ndarray:
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    return np.abs(out - ref) / np.abs(ref).max()


def test_adalayernorm_and_attention_blocks_match_jax_bf16(den):
    lp = den["params"]["layer0"]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 100, E)).astype(np.float32)
    t = np.array([5, 700])
    jada = jax.jit(lambda p, x, t: JD.AdaLayerNorm(E, 1000, BF16).apply({"params": p}, x, t))(
        lp["norm1"], x, t)
    h = np.asarray(jada, np.float32)
    tok = np.arange(100) // L
    bias = np.where(tok[:, None] == tok[None], 0, -1e9).astype(np.float32)[None, None]
    jatt = jax.jit(lambda p, x: JD.MultiHeadAttention(E, H, 0.0, BF16).apply(
        {"params": p}, x, bias))(lp["self_attn"], h)
    errs = {}
    with torch.no_grad():
        for name, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
            layer = _port_den(den["params"], den["P"], dtype).transformer_layers[0]
            errs[name] = (_rel(layer.norm1(T(x), T(t)), jada).max(),
                          _rel(layer.self_attn(T(h), T(bias)), jatt).max())
    assert errs["bf16"][0] <= 1e-6 and errs["bf16"][1] <= 1e-6, errs
    assert errs["fp32"][0] >= 1e-4 and errs["fp32"][1] >= 1e-4, errs


def test_denoiser_forward_matches_jax_bf16_not_fp32(den):
    args = den["args"]
    jb = den["jden"].clone(dtype=BF16)
    ref = np.asarray(jax.jit(lambda p, *a: jb.apply({"params": p}, *a, train=False))(
        den["params"], *[jnp.asarray(a) for a in args]))
    shares, worst = {}, {}
    with torch.no_grad():
        for name, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
            out = _port_den(den["params"], den["P"], dtype)(*[T(a) for a in args])
            assert out.dtype == torch.float32
            d = _rel(out, ref)
            shares[name], worst[name] = float(np.mean(d < 1e-5)), float(d.max())
    assert shares["bf16"] >= 0.3 and worst["bf16"] <= 2e-2, (shares, worst)
    assert shares["fp32"] <= 0.05, shares  # a port computing in fp32 fails here


@pytest.fixture(scope="module")
def vq():
    """A small VQ-VAE with non-trivial BatchNorm statistics and a unit-scale codebook."""
    rng = np.random.default_rng(2)
    jvq = JVQ(remat=False, **VQ_KW)
    v = _np_tree(jit_init(jvq, jax.random.key(0), jnp.zeros((1, 96, 3)), train=False))
    p, st = v["params"], v["batch_stats"]
    for sa in ("sa1", "sa2", "sa3"):
        for j in range(3):
            c = p["pn2"][sa][f"bn{j}"]["scale"].shape[0]
            p["pn2"][sa][f"bn{j}"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            st["pn2"][sa][f"bn{j}"]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            st["pn2"][sa][f"bn{j}"]["var"] = rng.uniform(0.5, 2, c).astype(np.float32)
    p["vector_quantization"]["embedding"] = rng.uniform(-1, 1, (32, 16)).astype(np.float32)
    return dict(jvq=jvq, params=p, stats=st)


def _port_vq(vq, dtype):
    m = TVQ(**VQ_KW)
    m.load_state_dict(from_jax.vqvae_state_dict(vq["params"], vq["stats"]))
    return m.eval().with_dtype(dtype)


def test_composable_encode_matches_jax_bf16(vq):
    x = (np.random.default_rng(3).normal(size=(16, 96, 3)) * 0.4).astype(np.float32)
    jb = vq["jvq"].clone(dtype=BF16)
    jz = jax.jit(lambda p, s, x: jb.apply({"params": p, "batch_stats": s}, x,
                                           method=lambda m, x: m.encode(x)))(
        vq["params"], vq["stats"], x)
    jze = jax.jit(lambda p, s, x: jb.apply({"params": p, "batch_stats": s}, x,
                                            method=lambda m, x: m.pn2.encode(x)[0]))(
        vq["params"], vq["stats"], x)
    cb = vq["params"]["vector_quantization"]["embedding"]
    with torch.no_grad():
        model = _port_vq(vq, torch.bfloat16)
        out = model.encode(T(x))
        fp32 = _port_vq(vq, None).encode(T(x))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    d = _rel(out["z_e"], jze)
    assert d.max() <= 5e-3 and np.mean(d < 1e-5) >= 0.99, (d.max(), np.mean(d < 1e-5))
    assert np.mean(_rel(fp32["z_e"], jze) < 1e-5) <= 0.05  # fp32 is another function

    def codes(z):
        z = np.asarray(z, np.float32).reshape(-1, 16)
        return ((z ** 2).sum(1)[:, None] + (cb ** 2).sum(1) - 2 * z @ cb.T).argmin(1)
    equal = np.mean(codes(out["z_e"].numpy()) == codes(jze))
    assert equal >= 0.99, equal
    same = codes(out["z_e"].numpy()) == codes(jze)
    # the JAX z_q is the straight-through z + (code - z), the code to about 1e-8
    np.testing.assert_allclose(out["z_q"].numpy().reshape(-1, 16)[same],
                               np.asarray(jz["z_q"]).reshape(-1, 16)[same], atol=1e-6)


def test_train_step_matches_jax_bf16(den, vq):
    """Loss and every gradient of one bf16 step against the JAX package's bf16 loss_fn
    (its frozen encoder cloned to bf16, as ``training/denoiser.py::load_frozen_encoder``);
    then one AdamW step keeps the parameters and the optimizer's state fp32."""
    rng = np.random.default_rng(20)
    B, P, N = 2, 4, 96
    quat = rng.normal(size=(B, P, 4)).astype(np.float32)
    batch = {
        "part_pcs": (rng.normal(size=(B, P, N, 3)) * 0.4).astype(np.float32),
        "part_valids": np.array([[1, 1, 1, 0], [1, 1, 1, 1]], np.float32),
        "part_scale": rng.uniform(0.2, 1.0, size=(B, P, 1)).astype(np.float32),
        "part_trans": (rng.normal(size=(B, P, 3)) * 0.3).astype(np.float32),
        "part_rots": quat / np.linalg.norm(quat, axis=-1, keepdims=True),
        "ref_part": np.array([[True, False, False, False], [False, False, True, False]]),
    }
    key = jax.random.key(7)
    t_rng, n_rng, _ = jax.random.split(key, 3)  # the draws of the JAX loss_fn, in its order
    timesteps = np.asarray(jax.random.randint(t_rng, (B,), 0, 1000))
    noise = np.asarray(jax.random.normal(n_rng, (B, P, 7)))
    jenc = jsampler.make_frozen_encoder(vq["jvq"].clone(remat=False, dtype=BF16),
                                        vq["params"], vq["stats"])
    jden = den["jden"].clone(dtype=BF16)
    (jloss, _), jgrads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        den["params"], jden, jenc, jsched.DDPMParams.piecewise(),
        {k: jnp.asarray(v) for k, v in batch.items()}, key, True)
    model = _port_den(den["params"], P, torch.bfloat16).train()
    encoder = tsampler.make_frozen_encoder(_port_vq(vq, torch.bfloat16))
    state = tstate.adamw_reference(model, 2e-4, 0.95, 0.999, 1e-6)
    state.model.train()
    loss, _ = ttrain.loss_fn(model, encoder, tsched.DDPMParams.piecewise(),
                             {k: T(v) for k, v in batch.items()}, timesteps=T(timesteps),
                             noise=T(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-3)
    sd_grads = {n: p.grad for n, p in model.named_parameters()}
    ref = from_jax.denoiser_state_dict(_np_tree(jgrads))
    for n, g in sd_grads.items():
        r = ref[n]
        assert g.dtype == torch.float32, n
        l2 = float((g - r).norm() / r.norm().clamp_min(1e-30))
        assert l2 <= 5e-2, (n, l2)
    state.optimizer.step()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(v.dtype == torch.float32 for s in state.optimizer.state.values()
               for v in s.values() if torch.is_tensor(v) and v.is_floating_point())


def _tiny_cfg(precision):
    cfg = R.Config()
    cfg.trainer.precision = precision
    cfg.data.max_num_part = 5
    for sub in (cfg.denoiser, cfg.verifier):
        sub.embed_dim, sub.num_layers, sub.num_heads = 32, 1, 2
    return cfg


def test_make_models_builds_the_bf16_denoiser_with_fp32_parameters():
    """``inference/run.py::make_models`` (and so ``build_engine_fn`` and
    ``data/verifier_gen.py::denoiser_sample_fn``) under ``trainer.precision=bf16``: bf16
    compute, fp32 parameters, as the JAX entry builds its models; fp32 otherwise."""
    for precision, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
        vqvae, denoiser, verifier = R.make_models(_tiny_cfg(precision))
        assert denoiser.dtype is dtype and vqvae.pn2.dtype is dtype
        assert all(layer.self_attn.dtype is dtype for layer in denoiser.transformer_layers)
        for m in (vqvae, denoiser, verifier):
            assert all(p.dtype == torch.float32 for p in m.parameters())
    enc = ttrain.load_frozen_encoder(_tiny_cfg("bf16"), "cpu")
    assert enc.model.pn2.sa2.dtype is torch.bfloat16
    assert all(w.dtype == torch.float32 for stage in ("sa1", "sa2", "sa3")
               for layer in enc.w[stage] for w in layer)


def test_engine_under_bf16_passes_fp32_weights_to_kernel_s(monkeypatch, tmp_path):
    """The engine's cached encode calls kernel S with the fp32 folded weights under bf16,
    as the JAX package's fused-cached encode does on a TPU, while its denoiser computes in
    bf16; the engine's results are finite."""
    from puzzlefusion_plusplus_tpu_torch.data import generate_dataset
    from puzzlefusion_plusplus_tpu_torch.inference import sampler

    root = str(tmp_path)
    generate_dataset(root, num_shapes=2, seed=4, split="val", min_parts=3, max_parts=5,
                     n_points=96)
    cfg = _tiny_cfg("bf16")
    cfg.data.data_val_dir = root + "/pc_data/val"
    cfg.data.matching_data_path = root + "/matching_data"
    cfg.verifier.max_iters = 1
    cfg.inference.save_trajectories = False
    seen, real = [], sampler.sa_stage_fused_cached

    def spy(*args, **kwargs):
        seen.append({a.dtype for a in args if isinstance(a, torch.Tensor)})
        return real(*args, **kwargs)

    monkeypatch.setattr(sampler, "sa_stage_fused_cached", spy)
    _, den_m, ver = R.make_models(cfg)
    vq_m = TVQ(**VQ_KW).with_dtype(torch.bfloat16)
    engine = R.build_engine_fn(cfg, "cpu", models=(vq_m, den_m, ver))
    agg = R.run_inference(cfg, engine=engine)
    assert seen and all(s <= {torch.float32, torch.int32, torch.int64} for s in seen), seen
    assert den_m.dtype is torch.bfloat16
    assert np.isfinite([agg[f"eval/{k}"] for k in R.METRIC_KEYS]).all()


def test_gather_takes_bf16_rows_exactly():
    """Kernels G and A take bf16 points (the composable bf16 encode's feature gathers): on
    the CPU the plain gather, exact and bf16; kernel G's unit is 16 bytes, 8 bf16 values."""
    from puzzlefusion_plusplus_tpu_torch.ops import gather as tga

    pts = torch.randn(3, 50, 24).bfloat16()
    idx = torch.randint(0, 50, (3, 7, 5), dtype=torch.int32)
    for fn in (tga.gather_points, tga.gather_points_approx):
        out = fn(pts, idx)
        assert out.dtype == torch.bfloat16
        assert torch.equal(out, pts[torch.arange(3)[:, None, None], idx.long()])
    assert tga.gather_width(24, 256, 2) == 8 and tga.gather_width(12, 256, 2) == 1
    assert tga.gather_width(12, 256, 4) == 4 and tga.gather_width(24, 264, 2) == 1
