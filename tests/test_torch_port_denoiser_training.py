"""Parity of the port's stage-2 denoiser training with the JAX package, on the CPU, where the
frozen encoder's kernels (F, G, A, S) run their plain versions.

Tolerances and why:
  * add_noise: 1e-6 (float32 on both sides, the same table).
  * loss_fn, in both encode modes: loss 1e-5 relative; every gradient within 1e-4 of its
    largest entry plus 1e-7 (the two frameworks sum the attention and the GEMMs in other
    orders); the JAX draws of ``training/denoiser.py:103-111`` are reproduced here and
    injected, and dropout is 0 on both sides (the two frameworks' dropout masks cannot
    agree). The fixture's codebook is spread to unit scale and every encoded code is checked
    to sit more than 1e-3 from a tie, so both sides choose the same codes.
  * train_step: the parameters after one AdamW step within 1e-6 where the gradient exceeds
    1e-4 of its largest entry, elsewhere within 2 lr (Adam's first step is about
    lr * sign(g)).
  * make_sample_fn / ddpm_sample: the 20-step trajectories 1e-3 on damped denoiser weights
    (0.05x, a contractive recurrence), with the JAX package's initial and per-step noise
    injected.
  * eval_metrics: part_acc exact (the fixture's parts sit far from the 0.01 chamfer bar),
    the rest 1e-4 relative.
  * DenoiserDataset("train"): every field exact, except the augmented arrays (1e-5: the JAX
    package may augment in its native library).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import jit_init

from puzzlefusion_plusplus_tpu.convert.torch_ckpt import convert_denoiser
from puzzlefusion_plusplus_tpu.data import generate_dataset as jgen
from puzzlefusion_plusplus_tpu.data.datasets import DenoiserDataset as JDS
from puzzlefusion_plusplus_tpu.data.loader import Loader as JLoader
from puzzlefusion_plusplus_tpu.inference import sampler as jsampler
from puzzlefusion_plusplus_tpu.models import scheduler as jsched
from puzzlefusion_plusplus_tpu.models.denoiser import DenoiserTransformer as JDen
from puzzlefusion_plusplus_tpu.models.vqvae import VQVAE as JVQ
from puzzlefusion_plusplus_tpu.training import denoiser as jtrain
from puzzlefusion_plusplus_tpu.training import state as jstate
from puzzlefusion_plusplus_tpu_torch.convert import from_jax
from puzzlefusion_plusplus_tpu_torch.data import DenoiserDataset, Loader, generate_dataset
from puzzlefusion_plusplus_tpu_torch.inference import sampler as tsampler
from puzzlefusion_plusplus_tpu_torch.models import scheduler as tsched
from puzzlefusion_plusplus_tpu_torch.models.denoiser import DenoiserTransformer as TDen
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE as TVQ
from puzzlefusion_plusplus_tpu_torch.training import denoiser as ttrain
from puzzlefusion_plusplus_tpu_torch.training import parity
from puzzlefusion_plusplus_tpu_torch.training import state as tstate
from puzzlefusion_plusplus_tpu_torch.training import vqvae as tvqtrain
from puzzlefusion_plusplus_tpu_torch.utils.config import Config, apply_overrides

torch.set_num_threads(2)


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


VQ_KW = dict(n_embeddings=32, embedding_dim=16, num_point=25, num_dim=64,
             sa_npoints=(24, 12), sa_nsamples=(8, 8, 8))
DEN_KW = dict(embed_dim=32, num_layers=2, num_heads=2, num_dim=64, num_point=25)
B_, P_, N_ = 2, 4, 96


def _port_den(params):
    m = TDen(32, 2, 2, 64, max_parts=P_, num_ada_embeds=1000, dropout=0.0, pe_dropout=0.0)
    m.load_state_dict(from_jax.denoiser_state_dict(params))
    return m


def _port_encoder(vq_params, vq_stats):
    m = TVQ(**VQ_KW)
    m.load_state_dict(from_jax.vqvae_state_dict(vq_params, vq_stats))
    return tsampler.make_frozen_encoder(m)


@pytest.fixture(scope="module")
def setup():
    """A small frozen encoder (non-trivial BatchNorm, codebook of unit scale), a small
    denoiser, a batch with an invalid slot and reference parts, and the JAX draws."""
    rng = np.random.default_rng(20)
    vq = JVQ(remat=False, **VQ_KW)
    v = _np_tree(jit_init(vq, jax.random.key(0), jnp.zeros((1, N_, 3)), train=False))
    vq_params, vq_stats = v["params"], v["batch_stats"]
    for sa in ("sa1", "sa2", "sa3"):
        for j in range(3):
            c = vq_params["pn2"][sa][f"bn{j}"]["scale"].shape[0]
            vq_params["pn2"][sa][f"bn{j}"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            vq_stats["pn2"][sa][f"bn{j}"]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            vq_stats["pn2"][sa][f"bn{j}"]["var"] = rng.uniform(0.5, 2, c).astype(np.float32)
    vq_params["vector_quantization"]["embedding"] = rng.uniform(
        -1, 1, size=(32, 16)).astype(np.float32)
    den = JDen(max_parts=P_, num_ada_embeds=1000, dropout=0.0, pe_dropout=0.0, **DEN_KW)
    L = 25
    dv = jit_init(den, jax.random.key(1), jnp.zeros((B_, P_, 7)), jnp.zeros((B_,), jnp.int32),
                  jnp.zeros((B_, P_, L, 64)), jnp.zeros((B_, P_, L, 3)), jnp.ones((B_, P_)),
                  jnp.ones((B_, P_, 1)), jnp.zeros((B_, P_), bool), train=False)
    den_params = _np_tree(dv["params"])
    quat = rng.normal(size=(B_, P_, 4)).astype(np.float32)
    batch = {
        "part_pcs": (rng.normal(size=(B_, P_, N_, 3)) * 0.4).astype(np.float32),
        "part_valids": np.array([[1, 1, 1, 0], [1, 1, 1, 1]], np.float32),
        "part_scale": rng.uniform(0.2, 1.0, size=(B_, P_, 1)).astype(np.float32),
        "part_trans": (rng.normal(size=(B_, P_, 3)) * 0.3).astype(np.float32),
        "part_rots": quat / np.linalg.norm(quat, axis=-1, keepdims=True),
        "ref_part": np.array([[True, False, False, False], [False, False, True, False]]),
    }
    jrng = jax.random.key(7)
    t_rng, n_rng, _ = jax.random.split(jrng, 3)  # the draws of loss_fn, in its order
    timesteps = np.asarray(jax.random.randint(t_rng, (B_,), 0, 1000))
    noise = np.asarray(jax.random.normal(n_rng, (B_, P_, 7)))
    jenc = jsampler.make_frozen_encoder(vq.clone(remat=False), vq_params, vq_stats)
    return dict(vq=vq, vq_params=vq_params, vq_stats=vq_stats, den=den, den_params=den_params,
                batch=batch, rng=jrng, timesteps=timesteps, noise=noise, jenc=jenc)


def test_add_noise_matches_jax():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(3, 5, 7)).astype(np.float32)
    eps = rng.normal(size=(3, 5, 7)).astype(np.float32)
    t = np.array([0, 499, 999])
    ref = np.asarray(jsched.add_noise(jsched.DDPMParams.piecewise(), jnp.asarray(x),
                                      jnp.asarray(eps), jnp.asarray(t)))
    out = tsched.add_noise(tsched.DDPMParams.piecewise(), T(x), T(eps), T(t))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


def _grad_tree(model):
    sd = dict(model.state_dict())
    for name, p in model.named_parameters():
        sd[name] = p.grad
    return convert_denoiser(sd)["params"]


def _assert_trees_close(out, ref, rel, atol, path=""):
    if isinstance(ref, dict):
        assert set(out) == set(ref), path
        for k in ref:
            _assert_trees_close(out[k], ref[k], rel, atol, f"{path}/{k}")
        return
    ref, out = np.asarray(ref), np.asarray(out)
    err = float(np.abs(out - ref).max())
    assert err <= rel * float(np.abs(ref).max()) + atol, f"{path}: max err {err}"


@pytest.mark.parametrize("encode_cached", [False, True])
def test_loss_and_every_gradient_match_jax(setup, encode_cached):
    s = setup
    jbatch = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    ddpm = jsched.DDPMParams.piecewise()
    (jloss, _), jgrads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        s["den_params"], s["den"], s["jenc"], ddpm, jbatch, s["rng"], True, None,
        encode_cached)
    model = _port_den(s["den_params"]).train()
    encoder = _port_encoder(s["vq_params"], s["vq_stats"])
    batch = {k: T(v) for k, v in s["batch"].items()}
    assert parity.code_margin(encoder, batch, T(s["timesteps"]), T(s["noise"])) > 1e-3
    loss, metrics = ttrain.loss_fn(model, encoder, tsched.DDPMParams.piecewise(), batch,
                                   encode_cached=encode_cached, timesteps=T(s["timesteps"]),
                                   noise=T(s["noise"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert float(metrics["mse_loss"]) == loss.item()
    _assert_trees_close(_grad_tree(model), _np_tree(jgrads), rel=1e-4, atol=1e-7)
    assert all(p.grad is None for p in encoder.model.parameters())  # frozen


def test_train_step_matches_jax(setup):
    s = setup
    lr = 2e-4
    tx = jstate.adamw_reference(lr, 0.95, 0.999, 1e-6)
    jnew, jmetrics = jtrain.train_step(
        jstate.create_state({"params": s["den_params"]}, tx),
        {k: jnp.asarray(v) for k, v in s["batch"].items()}, s["rng"], s["den"], s["jenc"],
        jsched.DDPMParams.piecewise(), tx)
    model = _port_den(s["den_params"])
    state = tstate.adamw_reference(model, lr, 0.95, 0.999, 1e-6)
    metrics = ttrain.train_step(state, {k: T(v) for k, v in s["batch"].items()},
                                _port_encoder(s["vq_params"], s["vq_stats"]),
                                tsched.DDPMParams.piecewise(), timesteps=T(s["timesteps"]),
                                noise=T(s["noise"]))
    assert state.step == 1 and int(jnew.step) == 1
    np.testing.assert_allclose(float(metrics["mse_loss"]), float(jmetrics["mse_loss"]),
                               rtol=1e-5)
    jbatch = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    _, jgrads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        s["den_params"], s["den"], s["jenc"], jsched.DDPMParams.piecewise(), jbatch, s["rng"],
        True)
    got = dict(jax.tree_util.tree_leaves_with_path(convert_denoiser(model.state_dict())["params"]))
    grads = dict(jax.tree_util.tree_leaves_with_path(_np_tree(jgrads)))
    for path, ref in jax.tree_util.tree_leaves_with_path(_np_tree(jnew.params)):
        g = np.abs(grads[path])
        err = np.abs(np.asarray(got[path]) - ref)
        assert err[g > 1e-4 * g.max()].max(initial=0) <= 1e-6, jax.tree_util.keystr(path)
        assert err.max() <= 2 * lr + 1e-6, jax.tree_util.keystr(path)


def test_sampler_matches_jax(setup):
    """make_sample_fn (cache once, 20 steps of encode + denoise + DDPM step) against the
    JAX package's sampler body with the same initial and per-step noise."""
    s = setup
    damped = jax.tree.map(lambda a: a * 0.05, s["den_params"])
    rng = np.random.default_rng(22)
    init = rng.normal(size=(B_, P_, 7)).astype(np.float32)
    noise_seq = rng.normal(size=(20, B_, P_, 7)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    gt = jnp.concatenate([jb["part_trans"], jb["part_rots"]], -1)
    ref = jb["ref_part"]
    cache = jsampler.build_feature_cache(s["jenc"], jb["part_pcs"], jb["part_valids"])

    def denoise_fn(noisy, t):
        latent, xyz = jsampler.extract_features(s["jenc"], jb["part_pcs"], jb["part_valids"],
                                                noisy, cache)
        return s["den"].apply({"params": damped}, noisy, t, latent, xyz, jb["part_valids"],
                              jb["part_scale"], ref, train=False)

    ddpm = jsched.DDPMParams.piecewise()
    jfinal, jtraj = jax.jit(lambda i, z: jsampler.ddpm_sample(
        denoise_fn, ddpm, jnp.asarray(jsched.leading_timesteps(1000, 20)), i, ref,
        jnp.where(ref[..., None], gt, 0.0), jax.random.key(0), 20, noise_seq=z))(
            jnp.asarray(init), jnp.asarray(noise_seq))
    sample = ttrain.make_sample_fn(_port_den(damped), _port_encoder(s["vq_params"],
                                                                    s["vq_stats"]),
                                   tsched.DDPMParams.piecewise(), 20)
    final, traj = sample({k: T(v) for k, v in s["batch"].items()}, init=T(init),
                         noise_seq=T(noise_seq))
    assert traj.shape == (20, B_, P_, 7)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=1e-3)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), atol=1e-3)
    # reference parts stay pinned to the GT throughout
    np.testing.assert_array_equal(traj.numpy()[:, s["batch"]["ref_part"]],
                                  np.broadcast_to(np.asarray(gt)[s["batch"]["ref_part"]],
                                                  (20, 2, 7)))


def test_eval_metrics_match_jax(setup):
    s = setup
    rng = np.random.default_rng(23)
    gt = np.concatenate([s["batch"]["part_trans"], s["batch"]["part_rots"]], -1)
    final = gt.copy()
    final[:, 1:3] += rng.normal(size=(B_, 2, 7)).astype(np.float32)  # two parts far off
    final[:, 0, :3] += 1e-3  # one close
    jm = jtrain.eval_metrics(jnp.asarray(final), {k: jnp.asarray(v)
                                                 for k, v in s["batch"].items()})
    tm = ttrain.eval_metrics(T(final), {k: T(v) for k, v in s["batch"].items()})
    assert set(tm) == set(jm) == set(ttrain.EVAL_KEYS)
    np.testing.assert_array_equal(tm["part_acc"].numpy(), np.asarray(jm["part_acc"]))
    np.testing.assert_array_equal(tm["part_acc_nonref"].numpy(),
                                  np.asarray(jm["part_acc_nonref"]))
    for k in ("shape_cd", "rmse_r", "rmse_t"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-4)


def test_denoiser_dropout_is_train_mode_only(setup):
    """The dropouts carry no parameters (the weight bridge is unchanged), act in train
    mode and vanish in eval mode."""
    s = setup
    m = TDen(32, 2, 2, 64, max_parts=P_, num_ada_embeds=1000, dropout=0.5, pe_dropout=0.5)
    m.load_state_dict(from_jax.denoiser_state_dict(s["den_params"]))
    ref = _port_den(s["den_params"]).eval()
    rng = np.random.default_rng(24)
    args = (T(rng.normal(size=(B_, P_, 7)).astype(np.float32)), T(np.array([5, 700])),
            T(rng.normal(size=(B_, P_, 25, 64)).astype(np.float32)),
            T(rng.normal(size=(B_, P_, 25, 3)).astype(np.float32)),
            T(s["batch"]["part_valids"]), T(s["batch"]["part_scale"]),
            T(s["batch"]["ref_part"]))
    with torch.no_grad():
        torch.testing.assert_close(m.eval()(*args), ref(*args), rtol=0, atol=0)
        assert not torch.allclose(m.train()(*args), ref(*args))
    assert [type(d).__name__ for d in (m.transformer_layers[0].self_attn.to_out[1],
                                       m.transformer_layers[0].ff.net[1], m.pe_dropout)] == [
        "Dropout"] * 3
    cfg = Config()
    assert ttrain.make_model(cfg).transformer_layers[0].norm1.emb.num_embeddings == 3072
    cfg.denoiser.embed_dim = 32
    assert ttrain.make_model(cfg).transformer_layers[0].norm1.emb.num_embeddings == 1000


def test_denoiser_dataset_train_mode_matches_jax(tmp_path):
    root = str(tmp_path)
    jgen(root, num_shapes=6, seed=8, split="train", min_parts=3, max_parts=6, n_points=64)
    kw = dict(mode="train", max_num_part=6, multiple_ref_parts=True)
    ref = list(JLoader(JDS(root + "/pc_data/train", **kw), 3, seed=3))
    out = list(Loader(DenoiserDataset(root + "/pc_data/train", **kw), 3, seed=3))
    assert len(out) == len(ref) == 2
    assert max(int(b["ref_part"].sum(-1).max()) for b in out) > 1  # the curriculum fired
    for ob, rb in zip(out, ref):
        assert set(ob) == set(rb)
        for k in rb:
            if k in ("part_pcs", "part_trans", "part_rots", "part_scale", "part_pcs_gt",
                     "init_pose_r", "init_pose_t"):
                np.testing.assert_allclose(ob[k], rb[k], atol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(np.asarray(ob[k]), np.asarray(rb[k]), k)


def _tiny_cfg(root):
    return apply_overrides(Config(), [
        f"data.data_dir={root}/pc_data/train", f"data.data_val_dir={root}/pc_data/val",
        "data.batch_size=2", "data.val_batch_size=2", "data.max_num_part=4",
        "ae.n_embeddings=32", "denoiser.embed_dim=32", "denoiser.num_layers=1",
        "denoiser.num_heads=2", "denoiser.epochs=1", "denoiser.val_every=1",
        "trainer.log_every=1", f"trainer.output_dir={root}/out",
    ])


def test_trainer_runs_on_cpu_and_needs_cuda_otherwise(tmp_path, monkeypatch):
    """Two steps and a validation pass with a stage-1 checkpoint as the encoder, then a
    resume that continues the step count."""
    root = str(tmp_path)
    generate_dataset(root, num_shapes=4, seed=11, split="train", min_parts=2, max_parts=4,
                     n_points=1000)
    generate_dataset(root, num_shapes=2, seed=12, split="val", min_parts=2, max_parts=4,
                     n_points=1000)
    cfg = _tiny_cfg(root)
    torch.manual_seed(3)
    ae = tvqtrain.make_model(cfg)
    ae_ckpt = tstate.save_checkpoint(root + "/ae_ckpt", tstate.adamw_multistep(ae, 1e-3, ()))
    cfg.denoiser.encoder_ckpt_path = ae_ckpt
    enc = ttrain.load_frozen_encoder(cfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(enc.model.state_dict().values(),
                                                 ae.state_dict().values()))
    state = ttrain.train(cfg, device="cpu")  # one epoch: 2 steps, then validation
    assert state.step == 2
    out = os.path.join(root, "out", "everyday", "denoiser")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(r["mse_loss"]) for r in recs[:2])
    assert all(np.isfinite(recs[2][f"eval_{k}"]) for k in ttrain.EVAL_KEYS)
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["step_2", "topk.json"]
    cfg.denoiser.epochs = 2
    cfg.denoiser.train_encode_cached = True
    assert ttrain.train(cfg, max_steps=3, device="cpu").step == 3  # resumed at step 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main([f"data.data_dir={root}/pc_data/train"])


def test_device_parity_check_accepts_equal_denoiser_steps_and_catches_a_missing_gradient(
        setup):
    """``training/parity.py``'s denoiser step, both sides on the CPU; a zeroed gradient must
    be named."""
    s = setup
    sd = _port_den(s["den_params"]).state_dict()

    def make():
        return TDen(32, 2, 2, 64, max_parts=P_, num_ada_embeds=1000, dropout=0.0,
                    pe_dropout=0.0)

    def make_encoder(device):
        return _port_encoder(s["vq_params"], s["vq_stats"])

    args = (make, sd, make_encoder, s["batch"], "cpu", T(s["timesteps"]), T(s["noise"]))
    ref = parity.denoiser_step_on(*args)
    assert ref["code_margin"] > 1e-3
    errs = parity.compare(ref, parity.denoiser_step_on(*args), ("mse_loss",))
    assert errs["grad_max_rel"] == 0.0 and errs["param_after_step_any"] == 0.0
    name = "transformer_layers.1.ff.net.0.proj.weight"
    bad = {**ref, "grads": {**ref["grads"], name: torch.zeros_like(ref["grads"][name])}}
    with pytest.raises(AssertionError, match=name):
        parity.compare(ref, bad, ("mse_loss",))
