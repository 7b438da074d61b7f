"""The port's evaluation scripts (``puzzlefusion_plusplus_tpu_torch/scripts/``) against the
root ``scripts/`` of the JAX package, on the CPU, on the same seeded inputs.

* evidence: the seven cases of ``tests/test_evidence.py`` against the port's module, and
  ``loss_plateaued`` equal to ``scripts/evidence.py``'s on the same files (exact: the same
  arithmetic on the same floats).
* engine_breakdown: a CPU engine run's ``breakdown.jsonl`` analysed by both, equal dicts
  (exact).
* part_acc_floor: the floors of a generated split equal to the JAX script's (exact after its
  rounding to 4 places: the synthetic parts sit far from the 0.01 chamfer bar at identity
  and random poses).
* overfit_step: one step against the composition of ``scripts/overfit_proof.py:117-135``
  from the JAX package's functions (the script runs at import), with the weights carried
  across by ``convert/from_jax`` and the same timesteps and noise: the loss within 1e-5
  relative; the parameters after the step within ``training/parity.py``'s denoiser
  tolerance (1e-6 where the gradient is clear of 0 beyond twice its elementwise tolerance
  1e-3 of the largest entry plus 1e-5, elsewhere 2 lr).
* the scripts end to end at test widths: ``overfit_proof.run`` (finite curve, the MSE on
  the held draws falls over 6 steps, both engine modes, checkpoints and summary, a second call resuming),
  ``synthetic_train_eval.run`` at N_TRAIN=4 N_VAL=2 (the JAX payload's keys, a manifest
  line), then ``eval_train_split``, ``rescore_checkpoints``, ``denoiser_extend`` and
  ``verifier_regen_eval`` once each on that run root.
"""

import importlib
import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import jit_init

from puzzlefusion_plusplus_tpu.inference import sampler as jsampler
from puzzlefusion_plusplus_tpu.models import scheduler as jsched
from puzzlefusion_plusplus_tpu.models.denoiser import DenoiserTransformer as JDen
from puzzlefusion_plusplus_tpu.models.vqvae import VQVAE as JVQ
from puzzlefusion_plusplus_tpu.training import state as jstate
from puzzlefusion_plusplus_tpu_torch.convert import from_jax
from puzzlefusion_plusplus_tpu_torch.data import generate_dataset
from puzzlefusion_plusplus_tpu_torch.inference import sampler as tsampler
from puzzlefusion_plusplus_tpu_torch.models import scheduler as tsched
from puzzlefusion_plusplus_tpu_torch.models.denoiser import DenoiserTransformer as TDen
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE as TVQ
from puzzlefusion_plusplus_tpu_torch.scripts import cli_device, trained_steps
from puzzlefusion_plusplus_tpu_torch.scripts import denoiser_extend as extend
from puzzlefusion_plusplus_tpu_torch.scripts import engine_breakdown as breakdown
from puzzlefusion_plusplus_tpu_torch.scripts import eval_train_split as train_split
from puzzlefusion_plusplus_tpu_torch.scripts import evidence
from puzzlefusion_plusplus_tpu_torch.scripts import overfit_proof as overfit
from puzzlefusion_plusplus_tpu_torch.scripts import part_acc_floor as floor
from puzzlefusion_plusplus_tpu_torch.scripts import rescore_checkpoints as rescore
from puzzlefusion_plusplus_tpu_torch.scripts import synthetic_train_eval as synth
from puzzlefusion_plusplus_tpu_torch.scripts import verifier_regen_eval as regen
from puzzlefusion_plusplus_tpu_torch.training import parity
from puzzlefusion_plusplus_tpu_torch.training import state as tstate
from puzzlefusion_plusplus_tpu_torch.utils.config import Config, apply_overrides

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name: str):
    """A root ``scripts/`` module loaded by path, unedited."""
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _narrow(overrides=()) -> Config:
    """Test widths: denoiser and verifier 32/1/2, a 32-code codebook, 4 inference steps, one
    engine iteration (the VQ-VAE's SA stages stay at the config's widths)."""
    return apply_overrides(Config(), [
        "ae.n_embeddings=32", "denoiser.embed_dim=32", "denoiser.num_layers=1",
        "denoiser.num_heads=2", "denoiser.num_inference_steps=4", "verifier.embed_dim=32",
        "verifier.num_layers=1", "verifier.num_heads=2", "verifier.max_iters=1",
        "trainer.log_every=1", *overrides])


# ------------------------------------------------------------------ (a) evidence


def _write_metrics(path, values, key="cd_loss"):
    with open(path, "w") as fh:
        for i, v in enumerate(values):
            fh.write(json.dumps({"step": i * 50, key: v}) + "\n")


def test_plateau_detects_flat_series(tmp_path):
    p = tmp_path / "metrics.jsonl"
    _write_metrics(p, [5.0 - 0.1 * i for i in range(20)] + [3.0] * 20)
    done, info = evidence.loss_plateaued(str(p), "cd_loss", window=8)
    assert done, info
    assert info["rel_improve"] < 0.02


def test_plateau_keeps_extending_falling_series(tmp_path):
    p = tmp_path / "metrics.jsonl"
    _write_metrics(p, [10.0 - 0.2 * i for i in range(40)])
    done, info = evidence.loss_plateaued(str(p), "cd_loss", window=8)
    assert not done, info
    assert info["rel_improve"] > 0.02


def test_plateau_short_series_is_not_plateaued(tmp_path):
    p = tmp_path / "metrics.jsonl"
    _write_metrics(p, [1.0] * 5)
    done, _ = evidence.loss_plateaued(str(p), "cd_loss", window=8)
    assert not done


def test_plateau_max_mode_for_rising_metrics(tmp_path):
    p = tmp_path / "metrics.jsonl"
    _write_metrics(p, [0.1 + 0.02 * i for i in range(30)], key="eval_part_acc")
    done, _ = evidence.loss_plateaued(str(p), "eval_part_acc", window=8, mode="max")
    assert not done
    _write_metrics(p, [0.1 + 0.02 * i for i in range(15)] + [0.4] * 20, key="eval_part_acc")
    done, info = evidence.loss_plateaued(str(p), "eval_part_acc", window=8, mode="max")
    assert done, info


def test_plateau_tolerates_torn_tail_line(tmp_path):
    p = tmp_path / "metrics.jsonl"
    _write_metrics(p, [3.0] * 20)
    with open(p, "a") as fh:
        fh.write('{"step": 1000, "cd_l')  # killed mid-write
    done, _ = evidence.loss_plateaued(str(p), "cd_loss", window=8)
    assert done


def test_collect_copies_metrics_and_manifests(tmp_path):
    run = tmp_path / "run" / "everyday" / "vqvae"
    run.mkdir(parents=True)
    _write_metrics(run / "metrics.jsonl", [1.0, 2.0])
    (run / "topk.json").write_text("{}")
    (tmp_path / "run" / "x.summary.json").write_text('{"a": 1}')
    dst = evidence.collect(str(tmp_path / "run"), "gen-test", extra={"stage": "A"},
                           evidence_dir=str(tmp_path / "evidence"))
    assert dst == str(tmp_path / "evidence" / "gen-test")
    names = sorted(os.listdir(dst))
    assert "MANIFEST.jsonl" in names
    assert "everyday__vqvae__metrics.jsonl" in names
    assert "x.summary.json" in names and "everyday__vqvae__topk.json" in names
    manifest = [json.loads(line) for line in open(os.path.join(dst, "MANIFEST.jsonl"))]
    assert manifest[-1]["extra"] == {"stage": "A"}
    assert len(manifest[-1]["files"]) == 3
    # collecting again appends a manifest line and overwrites the files
    evidence.collect(str(tmp_path / "run"), "gen-test", evidence_dir=str(tmp_path / "evidence"))
    manifest = [json.loads(line) for line in open(os.path.join(dst, "MANIFEST.jsonl"))]
    assert len(manifest) == 2


def test_write_summary_roundtrip(tmp_path):
    path = evidence.write_summary(str(tmp_path), "engine", {"part_acc": 0.5})
    assert json.load(open(path)) == {"part_acc": 0.5}


def test_evidence_defaults_to_the_ports_own_tree():
    assert evidence.EVIDENCE_DIR == os.path.join(REPO, "chiprun_out", "evidence")
    assert not evidence.EVIDENCE_DIR.startswith(os.path.join(REPO, "evidence"))


@pytest.mark.parametrize("series,mode,window", [
    ([5.0 - 0.1 * i for i in range(20)] + [3.0] * 20, "min", 8),
    ([10.0 - 0.2 * i for i in range(40)], "min", 8),
    ([1.0] * 5, "min", 8),
    ([0.1 + 0.02 * i for i in range(15)] + [0.4] * 20, "max", 5),
    ([0.3, 0.31, 0.29, 0.33, 0.35, 0.36, 0.34, 0.38, 0.37, 0.4, 0.41], "max", 5),
])
def test_loss_plateaued_matches_jax_script(tmp_path, series, mode, window):
    jev = _jax_script("evidence")
    p = tmp_path / "metrics.jsonl"
    _write_metrics(p, series, key="m")
    with open(p, "a") as fh:
        fh.write('{"step": 9999, "m"')  # a torn tail line
    for rel in (0.01, 0.02):
        assert (evidence.loss_plateaued(str(p), "m", window, rel, mode)
                == jev.loss_plateaued(str(p), "m", window, rel, mode))
    assert evidence.read_metric(str(p), "m") == jev.read_metric(str(p), "m")


# ------------------------------------------------------------------ (c) the floors


@pytest.mark.parametrize("with_matching", [True, False])
def test_part_acc_floor_matches_jax_script(tmp_path, with_matching):
    root = str(tmp_path)
    generate_dataset(root, num_shapes=6, seed=5, split="val", min_parts=2, max_parts=6,
                     n_points=64, with_matching=with_matching, with_verifier=False)
    val_dir = root + "/pc_data/val"
    ref = _jax_script("part_acc_floor").main(val_dir, None)
    out = floor.main([val_dir, "--cpu"])
    assert out == ref
    assert out["n_shapes"] == 6 and 0 < out["ref_floor"] <= out["ref_part_fraction_mean"] + 1
    assert floor.floors(val_dir, 4, device="cpu") == _jax_script("part_acc_floor").main(
        val_dir, 4)


# ------------------------------------------------------------------ (d) the overfit step


VQ_KW = dict(n_embeddings=32, embedding_dim=16, num_point=25, num_dim=64,
             sa_npoints=(24, 12), sa_nsamples=(8, 8, 8))
B_, P_, N_, LR = 2, 4, 96, 2e-4


@pytest.fixture(scope="module")
def step_setup():
    """A small frozen encoder (codebook of unit scale, non-trivial BatchNorm), a small
    denoiser, a batch with an invalid slot and reference parts, timesteps from the 20
    inference timesteps and noise, all from numpy seeds."""
    rng = np.random.default_rng(40)
    vq = JVQ(remat=False, **VQ_KW)
    v = jax.tree.map(np.asarray, jit_init(vq, jax.random.key(0), jnp.zeros((1, N_, 3)),
                                          train=False))
    vq_params, vq_stats = v["params"], v["batch_stats"]
    for sa in ("sa1", "sa2", "sa3"):
        for j in range(3):
            c = vq_params["pn2"][sa][f"bn{j}"]["scale"].shape[0]
            vq_params["pn2"][sa][f"bn{j}"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            vq_stats["pn2"][sa][f"bn{j}"]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            vq_stats["pn2"][sa][f"bn{j}"]["var"] = rng.uniform(0.5, 2, c).astype(np.float32)
    vq_params["vector_quantization"]["embedding"] = rng.uniform(
        -1, 1, size=(32, 16)).astype(np.float32)
    den = JDen(embed_dim=32, num_layers=2, num_heads=4, num_dim=64, num_point=25,
               max_parts=P_, num_ada_embeds=1000, dropout=0.0, pe_dropout=0.0)
    L = 25
    den_params = jax.tree.map(np.asarray, jit_init(
        den, jax.random.key(1), jnp.zeros((B_, P_, 7)), jnp.zeros((B_,), jnp.int32),
        jnp.zeros((B_, P_, L, 64)), jnp.zeros((B_, P_, L, 3)), jnp.ones((B_, P_)),
        jnp.ones((B_, P_, 1)), jnp.zeros((B_, P_), bool), train=False)["params"])
    quat = rng.normal(size=(B_, P_, 4)).astype(np.float32)
    batch = {
        "part_pcs": (rng.normal(size=(B_, P_, N_, 3)) * 0.4).astype(np.float32),
        "part_valids": np.array([[1, 1, 1, 0], [1, 1, 1, 1]], np.float32),
        "part_scale": rng.uniform(0.2, 1.0, size=(B_, P_, 1)).astype(np.float32),
        "part_trans": (rng.normal(size=(B_, P_, 3)) * 0.3).astype(np.float32),
        "part_rots": quat / np.linalg.norm(quat, axis=-1, keepdims=True),
        "ref_part": np.array([[True, False, False, False], [False, False, True, False]]),
    }
    infer_ts = jsched.leading_timesteps(1000, 20)
    t = infer_ts[rng.integers(0, 20, size=B_)]
    noise = rng.normal(size=(B_, P_, 7)).astype(np.float32)
    return dict(vq=vq, vq_params=vq_params, vq_stats=vq_stats, den=den, den_params=den_params,
                batch=batch, t=t, noise=noise)


def _jax_overfit_step(s):
    """The step of ``scripts/overfit_proof.py:117-135``, composed from the JAX package."""
    enc = jsampler.make_frozen_encoder(s["vq"].clone(remat=False), s["vq_params"],
                                       s["vq_stats"])
    ddpm = jsched.DDPMParams.piecewise(1000)
    b = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    t, noise = jnp.asarray(s["t"]), jnp.asarray(s["noise"])
    gt = jnp.concatenate([b["part_trans"], b["part_rots"]], -1)
    ref = b["ref_part"].astype(bool)
    w = ((b["part_valids"] > 0) & ~ref)[..., None].astype(jnp.float32)
    tx = jstate.adamw_reference(LR)
    state = jstate.create_state({"params": s["den_params"]}, tx)

    def lf(params):
        noisy = jsched.add_noise(ddpm, gt, noise, t)
        noisy = jnp.where(ref[..., None], gt, noisy)
        latent, xyz = jsampler.extract_features(enc, b["part_pcs"], b["part_valids"], noisy)
        pred = s["den"].apply({"params": params}, noisy, t, jax.lax.stop_gradient(latent),
                              jax.lax.stop_gradient(xyz), b["part_valids"], b["part_scale"],
                              ref, train=False)
        return ((pred - noise) ** 2 * w).sum() / jnp.maximum(w.sum() * 7.0, 1.0)

    loss, grads = jax.jit(jax.value_and_grad(lf))(state.params)
    updates, _ = tx.update(grads, state.opt_state, state.params)
    new = jax.tree.map(lambda p, u: p + u, state.params, updates)
    return float(loss), jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, new)


def test_overfit_step_matches_jax(step_setup):
    s = step_setup
    jloss, jgrads, jnew = _jax_overfit_step(s)
    model = TDen(32, 2, 4, 64, max_parts=P_, num_ada_embeds=1000, dropout=0.0, pe_dropout=0.0)
    model.load_state_dict(from_jax.denoiser_state_dict(s["den_params"]))
    ae = TVQ(**VQ_KW)
    ae.load_state_dict(from_jax.vqvae_state_dict(s["vq_params"], s["vq_stats"]))
    encoder = tsampler.make_frozen_encoder(ae)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in s["batch"].items()}
    t, noise = torch.from_numpy(s["t"]), torch.from_numpy(s["noise"])
    assert parity.code_margin(encoder, batch, t, noise) > 1e-3  # no code near a tie
    opt = tstate.adamw_reference(model, LR).optimizer
    loss = overfit.overfit_step(model, opt, encoder, tsched.DDPMParams.piecewise(1000), batch,
                                t, noise)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    assert all(p.grad is None for p in ae.parameters())  # the encoder stays frozen
    got = from_jax.denoiser_state_dict(jnew)
    grads = from_jax.denoiser_state_dict(jgrads)
    assert {n for n, _ in model.named_parameters()} == set(got)
    for name, p in model.named_parameters():
        g = torch.as_tensor(grads[name]).abs()
        clear = g > 2 * (parity.GRAD_REL * g.max().item() + parity.GRAD_ATOL)
        err = (p.detach() - torch.as_tensor(got[name])).abs()
        assert err[clear].max().item() <= 1e-6 if clear.any() else True, name
        assert err.max().item() <= 2 * LR + 1e-6, name


# ------------------------------------------------------------------ (e) the scripts end to end


OVERFIT_STEPS = 6  # the denoiser's steps in the CPU overfit run; evaluated at 1, 3 and 6


@pytest.fixture(scope="module")
def overfit_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("overfit"))
    ev = str(tmp_path_factory.mktemp("evidence"))
    cfg = _narrow(["data.max_num_part=6", "denoiser.lr=1e-3"])
    summary = overfit.run(cfg, root, num_shapes=1, steps_ae=1, steps_dn=OVERFIT_STEPS,
                          steps_vf=2, eval_every=3, batch=2, device="cpu", evidence_dir=ev)
    return dict(root=root, ev=ev, cfg=cfg, summary=summary)


def test_overfit_proof_runs_and_learns(overfit_run):
    s = overfit_run["summary"]
    curve = s["curve"]
    assert [p["step"] for p in curve] == [1, 3, OVERFIT_STEPS]
    assert all(math.isfinite(v) for p in curve for v in p.values())
    # the MSE on the held draws falls at every point of the 6 steps
    assert curve[0]["mse_held"] > curve[1]["mse_held"] > curve[2]["mse_held"]
    assert set(s["engine"]) == {"no-merge", "full"}
    for res in s["engine"].values():
        assert all(math.isfinite(res[k]) for k in ("part_acc", "shape_cd", "rmse_r", "rmse_t"))
        assert res["merged_pairs"] >= 0
    assert s["engine"]["no-merge"]["merged_pairs"] == 0  # threshold 1.1: nothing merges
    assert s["engine"]["full"]["verifier"] == s["checkpoints"]["verifier"]
    for path in s["checkpoints"].values():
        assert path.startswith(overfit_run["root"]) and os.path.isdir(path)
    assert s["steps"]["denoiser"] == OVERFIT_STEPS and s["batch"] == 2
    assert s["device"] == "cpu"
    out = overfit_run["root"] + "/out"
    assert json.load(open(out + "/overfit.summary.json"))["curve"] == curve
    dst = os.path.join(overfit_run["ev"], "overfit1")
    assert "overfit.summary.json" in os.listdir(dst)
    assert "everyday__vqvae__metrics.jsonl" in os.listdir(dst)
    assert len(open(os.path.join(dst, "MANIFEST.jsonl")).readlines()) == 1


def test_overfit_proof_resumes_from_its_checkpoints(overfit_run):
    """A second call skips the three trained stages and returns the same curve; stage 2
    keeps one checkpoint, holding its progress."""
    r = overfit_run
    again = overfit.run(r["cfg"], r["root"], num_shapes=1, steps_ae=1, steps_dn=OVERFIT_STEPS,
                        steps_vf=2, eval_every=3, batch=2, device="cpu", evidence_dir=r["ev"])
    assert again["curve"] == r["summary"]["curve"]
    assert again["denoiser_s_per_step"] is None  # no step ran
    assert again["engine"] == r["summary"]["engine"]
    ckpts = os.listdir(r["root"] + "/out/everyday/denoiser/ckpt")
    assert ckpts == [f"step_{OVERFIT_STEPS}"]
    assert overfit.PROGRESS in os.listdir(r["root"] + f"/out/everyday/denoiser/ckpt/{ckpts[0]}")


GEN_KW = dict(n_train=4, n_val=2, steps_ae=2, steps_dn=2, steps_vf=2, min_parts=2,
              max_parts=4, plateau_x=1, batches={"vqvae": 2, "denoiser": 2,
                                                 "denoiser_val": 2, "verifier": 2,
                                                 "engine": 2})


@pytest.fixture(scope="module")
def gen_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gen"))
    ev = str(tmp_path_factory.mktemp("evidence"))
    cfg = _narrow(["data.max_num_part=4"])
    summary = synth.run(cfg, root, **GEN_KW, device="cpu", evidence_dir=ev)
    return dict(root=root, ev=ev, cfg=cfg, summary=summary)


def test_synthetic_train_eval_writes_the_jax_payload(gen_run):
    s = gen_run["summary"]
    # the keys of scripts/synthetic_train_eval.py's write_summary("heldout_engine", ...)
    assert set(s) == {"metrics", "n_train", "n_val", "min_parts", "max_parts", "breakdown",
                      "reference_bar"}
    assert s["reference_bar"] == {"part_acc": 0.7018, "source": "docs/test.md:17",
                                  "nonref_equivalent": 0.65}
    assert s["metrics"]["num_samples"] == 2 and math.isfinite(s["metrics"]["eval/part_acc"])
    assert s["breakdown"]["n_shapes"] == 2
    for stage in ("vqvae", "denoiser", "verifier", "engine"):
        manifest = os.path.join(gen_run["ev"], "gen4", stage, "MANIFEST.jsonl")
        assert len(open(manifest).readlines()) >= 1, stage
    assert "heldout_engine.summary.json" in os.listdir(os.path.join(gen_run["ev"], "gen4",
                                                                    "engine"))
    for marker in (".done", ".stage1_plateau", ".stage2_plateau"):
        assert os.path.exists(gen_run["root"] + "/" + marker)


def test_synthetic_train_eval_refuses_a_loader_without_batches(tmp_path):
    """Every part bucket smaller than the denoiser's batch: the loader yields nothing an
    epoch (the JAX script then trains 0 denoiser steps); the port raises before stage 1."""
    cfg = _narrow(["data.max_num_part=4"])
    kw = {**GEN_KW, "batches": {**GEN_KW["batches"], "denoiser": 8}}
    with pytest.raises(ValueError, match="no denoiser training batch"):
        synth.run(cfg, str(tmp_path), **kw, device="cpu", evidence_dir=str(tmp_path / "ev"))
    assert not os.path.exists(tmp_path / "out")  # no stage ran
    assert synth.denoiser_batches(synth.gen_config(str(tmp_path), cfg), 2) == 2


def test_engine_breakdown_matches_jax_script(gen_run, tmp_path):
    """(b) The run's breakdown.jsonl, analysed by both modules."""
    inf_dir = gen_run["root"] + "/out/everyday/inference/results"
    recs = breakdown.load_records(inf_dir)
    jb = _jax_script("engine_breakdown")
    assert recs == jb.load_records(inf_dir) and len(recs) == 2
    assert breakdown.analyze(recs) == jb.analyze(jb.load_records(inf_dir))
    assert breakdown.summarize(inf_dir, "tag", str(tmp_path)) == jb.analyze(recs)
    assert json.load(open(tmp_path / "tag" / "engine_breakdown.summary.json")) == \
        json.loads(json.dumps(jb.analyze(recs)))


def test_eval_train_split_on_the_run_root(gen_run):
    s = train_split.run(gen_run["cfg"], gen_run["root"], n_train=4, subset=2, batch=2,
                        device="cpu", evidence_dir=gen_run["ev"])
    assert set(s["metrics"]) == {"part_acc", "part_acc_nonref", "shape_cd", "rmse_r", "rmse_t"}
    assert all(math.isfinite(v) for v in s["metrics"].values())
    assert s["best_ckpt"].startswith(gen_run["root"])
    assert os.path.exists(gen_run["root"] + "/out/engine_eval/trainsplit_sampling.summary.json")


def test_rescore_checkpoints_rewrites_the_index(gen_run):
    ckpt_dir = gen_run["root"] + "/out/everyday/denoiser/ckpt"
    before = json.load(open(ckpt_dir + "/topk.json"))
    s = rescore.run(gen_run["cfg"], gen_run["root"], n_train=4, seeds=2, batch=2,
                    device="cpu", evidence_dir=gen_run["ev"])
    after = json.load(open(ckpt_dir + "/topk.json"))
    assert set(after["entries"]) == set(s["scores"]) and after["rescored"]["seeds"] == 2
    assert after["raw"] == before["raw"]  # the raw single evaluations stay
    assert all(after["entries"][n] == s["scores"][n]["part_acc_mean"] for n in s["scores"])
    assert s["winner"] in s["scores"]
    assert ("heldout_engine_rescored_best" in s) == (s["winner"] != s["prev_best"])


def test_denoiser_extend_continues_from_the_latest(gen_run):
    ckpt_dir = gen_run["root"] + "/out/everyday/denoiser/ckpt"
    start = trained_steps(ckpt_dir)
    state = extend.run(gen_run["cfg"], gen_run["root"], epochs=2, batch=2, val_every=1,
                       device="cpu")
    assert state.step == start + 2  # one more epoch of 2 steps
    assert trained_steps(ckpt_dir) == state.step


def test_denoiser_extend_turns_a_deadline_into_steps():
    import datetime

    now = datetime.datetime(2026, 1, 1, 10, 0, 30, tzinfo=datetime.timezone.utc)
    assert extend.step_budget("10:30", 1.0, now) == 1770
    assert extend.step_budget("09:00", 1.0, now) == 0
    assert extend.step_budget("10:30", 1.5, now) == 2655


def test_verifier_regen_eval_on_the_run_root(gen_run):
    s = regen.run(gen_run["cfg"], gen_run["root"], n_train=4, max_samples=4, steps_vf=2,
                  verifier_batch=2, engine_batch=2, device="cpu", evidence_dir=gen_run["ev"])
    assert set(s["comparison"]) == {"synthetic-verifier", "denoiser-verifier"}
    for agg in s["comparison"].values():
        assert agg["num_samples"] == 2 and math.isfinite(agg["eval/part_acc"])
        assert agg["total_merged_pairs"] == agg["n_merged_pairs"]
    files = os.listdir(gen_run["root"] + "/verifier_data_dn")
    assert len(files) == 4  # one file a training shape, one round
    assert os.path.exists(os.path.join(gen_run["ev"], "gen4", "verifier_dn",
                                       "verifier_provenance_engine.summary.json"))


ENTRIES = ("part_acc_floor", "overfit_proof", "synthetic_train_eval", "eval_train_split",
           "rescore_checkpoints", "denoiser_extend", "verifier_regen_eval",
           "matcher_train_eval", "matcher_diagnosis", "matching_sensitivity_probe")


@pytest.mark.parametrize("name", ENTRIES)
def test_script_entry_needs_cuda_unless_cpu_asked(monkeypatch, name):
    mod = importlib.import_module(f"puzzlefusion_plusplus_tpu_torch.scripts.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        if name == "part_acc_floor":
            mod.floors("/nonexistent", device="cuda")
        elif name == "matcher_diagnosis":
            mod.run("/nonexistent", "/nonexistent/ckpt", device="cuda")
        else:
            mod.run(Config(), "/nonexistent", device="cuda")
    assert cli_device(["--cpu"]).type == "cpu"


def test_overfit_run_roots_are_the_ports_own(monkeypatch, tmp_path):
    """The run roots sit under the temporary directory as pfpp_torch_*, never at the JAX
    scripts' roots (their orbax checkpoints are not the port's format)."""
    from puzzlefusion_plusplus_tpu_torch.scripts import run_root

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    assert run_root("overfit_1") == os.path.join(str(tmp_path), "pfpp_torch_overfit_1")
    cfg = overfit.make_config(run_root("overfit_1"))
    assert cfg.trainer.output_dir.startswith(str(tmp_path))
    assert (cfg.data.batch_size, cfg.denoiser.dropout, cfg.denoiser.pe_dropout) == (1, 0, 0)
