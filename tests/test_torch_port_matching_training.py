"""The port's matcher training and matching-data writer against the JAX package, on the CPU,
and the train -> write -> serve round trip (``tests/test_matching_roundtrip.py`` is the
JAX package's).

The shapes have 320 points, not the module tests' 160: at 160 the train-mode BatchNorms sit
over so few distinct rows that the JAX package's float error alone (see
``tests/test_torch_port_matching.py``) takes the gradients 4.5e-2 apart in relative L2 norm,
near the 5e-2 bound; at 320 they are 1.3e-2 apart.

Tolerances and why:
  * one train step (all three losses on, Adam under the cosine schedule):
    ``training/parity.py::MATCHING_SMALL``: the losses and metrics 2e-3 relative, every
    gradient 5e-2 in relative L2 norm, the biases whose true gradient is 0 float noise,
    BatchNorm's running statistics 1e-4 relative, the parameters after the step within 1e-6
    where the gradient is clear of 0 (elsewhere 2 lr). The step is ill-conditioned at this
    size: ``test_step_is_ill_conditioned_on_one_device`` measures how far a 1e-6
    perturbation of the weights moves it on the CPU alone, and
    ``test_matching_tolerances_fail_a_planted_fault`` shows that a wrong gradient, a missing
    shard or a missing loss still fails them.
  * the host writer fed the JAX forward's outputs: every array of every npz equal, dtype
    included (the same numpy on the same inputs). The two forwards themselves (``ds_mat``
    1e-5 of its largest entry; ``cls_pred`` and ``crit_pid`` exact in eval mode): the
    Hungarian assignment of a near-uniform ``ds_mat`` (random weights) can flip on float
    error, so discrete outputs are compared only where the host half gets equal inputs.
  * the converter: the converted weights equal, the forward 1e-5 of the largest entry.
  * the round trip: the schema of the JAX writer and finite engine metrics.
"""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.helpers import jit_apply
from tests.test_torch_port_matching import flax_variables

from puzzlefusion_plusplus_tpu.data import generate_dataset as jgen
from puzzlefusion_plusplus_tpu.data.loader import Loader as JLoader
from puzzlefusion_plusplus_tpu.matching import train as jtrain
from puzzlefusion_plusplus_tpu.matching.dataset import AllPieceMatchingDataset as JDS
from puzzlefusion_plusplus_tpu.matching.generate import generate_matching_data as jgenerate
from puzzlefusion_plusplus_tpu.training import state as jstate
from puzzlefusion_plusplus_tpu_torch.convert.from_jax import matching_state_dict
from puzzlefusion_plusplus_tpu_torch.data import DenoiserDataset, Loader
from puzzlefusion_plusplus_tpu_torch.inference import run as R
from puzzlefusion_plusplus_tpu_torch.matching import eval as meval
from puzzlefusion_plusplus_tpu_torch.matching import generate as tgen
from puzzlefusion_plusplus_tpu_torch.matching import train as ttrain
from puzzlefusion_plusplus_tpu_torch.matching.dataset import AllPieceMatchingDataset as TDS
from puzzlefusion_plusplus_tpu_torch.matching.oracle import oracle_matching_stats
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE
from puzzlefusion_plusplus_tpu_torch.ops import gather
from puzzlefusion_plusplus_tpu_torch.training import parity
from puzzlefusion_plusplus_tpu_torch.training import state as tstate

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PTS, P, LR = 320, 5, 1e-3
RT_PTS = 160  # the round trip's, as the JAX package's round trip test
SMALL = dict(pc_feat_dim=32, aff_feat_dim=16, sa_npoints=(32, 16, 8, 4), max_num_part=P)
MATCH_KEYS = {"edges", "correspondence", "gt_pcs", "critical_pcs_idx", "n_pcs",
              "n_critical_pcs"}


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _numeric(batch):
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray) and v.dtype != object}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Three synthetic fractured shapes of 3-5 parts, no matching or verifier files."""
    root = str(tmp_path_factory.mktemp("mtrain"))
    jgen(root, num_shapes=3, seed=4, split="val", min_parts=3, max_parts=5, n_points=96,
         with_matching=False, with_verifier=False)
    return root


@pytest.fixture(scope="module")
def jax_model(root):
    """The small JAX matcher with the port's seeded weights, and a 2-shape batch."""
    jm = jtrain.make_model(**SMALL)
    batch = _numeric(next(iter(Loader(TDS(root + "/pc_data/val", num_points=N_PTS,
                                          max_num_part=P), 2, shuffle=False))))
    with torch.random.fork_rng():
        torch.manual_seed(0)
        v = flax_variables(ttrain.make_model(**SMALL))
    return jm, v, batch


def _port_model(v):
    model = ttrain.make_model(**SMALL)
    model.load_state_dict(matching_state_dict(v["params"], v["batch_stats"]))
    return model


# ------------------------------------------------------------------ one train step


@pytest.fixture(scope="module")
def steps(jax_model):
    """The JAX package's step (``loss_fn``'s value and gradient, then optax's Adam under the
    cosine schedule) in ``parity``'s result format, and the port's ``train_step``."""
    jm, v, batch = jax_model
    jb = {k: jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
          for k, x in batch.items()}
    fn = jax.jit(jax.value_and_grad(
        lambda p: jtrain.loss_fn(p, v["batch_stats"], jm, jb, 1.0, 1.0, True, None),
        has_aux=True))
    (_, (metrics, stats, *_)), grads = fn(v["params"])
    tx = optax.adam(optax.cosine_decay_schedule(LR, 1000))
    params = jax.tree.map(jnp.asarray, v["params"])
    updates, _ = tx.update(grads, tx.init(params), params)
    after = matching_state_dict(_np(jax.tree.map(lambda p, u: p + u, params, updates)),
                                _np(stats))
    ref = {"metrics": {k: float(x) for k, x in metrics.items()},
           "grads": matching_state_dict(_np(grads), {}),
           "buffers": {k: x for k, x in after.items() if "running" in k},
           "params": {k: x for k, x in after.items() if "running" not in k
                      and "num_batches" not in k},
           "lr": LR}
    make = functools.partial(ttrain.make_model, **SMALL)
    sd = matching_state_dict(v["params"], v["batch_stats"])
    return ref, parity.matching_step_on(make, sd, batch, "cpu"), make, sd, batch


def test_train_step_matches_jax(steps):
    ref, out = steps[:2]
    assert sorted(out["grads"]) == sorted(ref["grads"])
    errs = parity.compare(ref, out, ttrain.METRIC_KEYS, parity.MATCHING_SMALL)
    print(errs)
    assert out["metrics"]["mat_loss"] > 0 and out["metrics"]["cls_loss"] > 0


def test_step_is_ill_conditioned_on_one_device(steps):
    """What ``parity.MATCHING_SMALL`` rests on: a relative perturbation of 1e-6 of every
    weight moves the port's own CPU gradients by up to about 1e-2 in relative L2 norm (a
    wrong gradient is off by about 1) and its losses by far less than 2e-3."""
    _, out, make, sd, batch = steps
    gen = torch.Generator().manual_seed(1)
    bent = {k: x * (1 + 1e-6 * torch.randn(x.shape, generator=gen))
            if x.is_floating_point() and "running" not in k else x for k, x in sd.items()}
    moved = parity.matching_step_on(make, bent, batch, "cpu")
    l2 = {n: ((moved["grads"][n] - g).norm() / g.norm().clamp_min(1e-30)).item()
          for n, g in out["grads"].items() if not parity.MATCHING.zero_grad(n)}
    loss = {k: abs(moved["metrics"][k] - out["metrics"][k]) / max(abs(out["metrics"][k]), 1e-6)
            for k in ttrain.LOSS_KEYS}
    print(min(l2.values()), max(l2.values()), loss)
    assert 1e-3 < max(l2.values()) < parity.SA_GRAD_REL_L2
    assert max(loss.values()) < parity.MATCHING_SMALL.metric_rel / 4


@pytest.mark.parametrize("fault", ["scatter_drops_rows", "shard_left_out", "rigid_loss_off"])
def test_matching_tolerances_fail_a_planted_fault(steps, fault, monkeypatch):
    """A step with a planted fault fails ``parity.MATCHING_SMALL`` (and so ``MATCHING``)
    against the sound step, on its gradients: kernel B's plain version dropping the last
    quarter of its rows (the forward, and so the losses, unchanged), one of two ranks'
    shards left out of the global step, and the rigid loss off."""
    _, out, make, sd, batch = steps
    if fault == "scatter_drops_rows":
        plain = gather.scatter_add_plain

        def dropping(g, idx, n):
            keep = g.shape[1] - g.shape[1] // 4
            return plain(g[:, :keep], idx[:, :keep], n)

        monkeypatch.setattr(gather, "scatter_add_plain", dropping)
        bad = parity.matching_step_on(make, sd, batch, "cpu")
    elif fault == "shard_left_out":
        bad = parity.matching_step_on(make, sd, {k: v[:1] for k, v in batch.items()}, "cpu")
    else:
        bad = parity.matching_step_on(make, sd, batch, "cpu", w_rig=0.0)
    for tol in (parity.MATCHING_SMALL, parity.MATCHING):
        with pytest.raises(AssertionError, match="grad .*relative L2 error") as err:
            parity.compare(out, bad, ttrain.METRIC_KEYS, tol)
    lines = str(err.value).splitlines()[1:]
    print(fault, len(lines), "quantities outside:", *lines[:3])


# ------------------------------------------------------------------ the writer


def test_host_writer_fed_the_jax_forward_matches_the_jax_writer(root, jax_model, tmp_path):
    jm, v, _ = jax_model
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jres = jgenerate(jm, v["params"], v["batch_stats"], root + "/pc_data/val", jdir,
                     num_points=N_PTS, max_num_part=P, seed=0)
    port = _port_model(v)
    os.makedirs(tdir)
    rng = np.random.default_rng(0)
    edges = 0
    forward = jax.jit(functools.partial(jm.apply, train=False, use_pred_labels=True))
    for batch in JLoader(JDS(root + "/pc_data/val", num_points=N_PTS, max_num_part=P), 1,
                         shuffle=False, drop_last=False, seed=0):
        args = [jnp.asarray(batch["part_pcs"]), jnp.asarray(batch["piece_id"]),
                jnp.asarray(batch["part_valids"].sum(-1).astype(np.int32)),
                jnp.zeros(batch["piece_id"].shape, jnp.int32)]
        jout = _np(forward(v, *args))
        jout = {k: jout[k] for k in tgen.FORWARD_KEYS}
        # the port's forward on the same batch: close, and its discrete outputs equal here
        tout = tgen.matcher_forward(port, batch, "cpu")
        err = np.abs(tout["ds_mat"] - jout["ds_mat"]).max()
        assert err <= 1e-5 * np.abs(jout["ds_mat"]).max()
        for k in ("cls_pred", "crit_pid", "n_critical_sum"):
            np.testing.assert_array_equal(tout[k], jout[k], err_msg=k)
        edges += tgen.write_matching_shape(jout, batch, tdir, rng, P)["num_edges"]
    assert edges == sum(r["num_edges"] for r in jres) > 0
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 3
    for name in names:
        a, b = (np.load(os.path.join(d, name), allow_pickle=True) for d in (jdir, tdir))
        assert a.files == b.files and set(a.files) == MATCH_KEYS
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            if a[k].dtype == object:
                assert len(a[k]) == len(b[k])
                for x, y in zip(a[k], b[k]):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_orbax_matching_checkpoint_round_trips_through_the_converter(jax_model, tmp_path):
    jm, v, batch = jax_model
    spec = importlib.util.spec_from_file_location(
        "jax_ckpt_to_torch", os.path.join(REPO, "scripts", "jax_ckpt_to_torch.py"))
    conv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conv)
    state = jstate.create_state(v, optax.adam(1e-3))._replace(step=3)
    jstate.save_checkpoint(str(tmp_path / "orbax"), state, 3)
    conv.convert(str(tmp_path / "orbax"), str(tmp_path / "port"), "matching")
    sd = tstate.load_model_state(str(tmp_path / "port"))
    ref = matching_state_dict(v["params"], v["batch_stats"])
    assert sorted(sd) == sorted(ref) and all(torch.equal(sd[k], x) for k, x in ref.items())
    model = ttrain.make_model(**SMALL)
    model.load_state_dict(sd)
    nv = batch["part_valids"].sum(-1).astype(np.int32)
    args = (batch["part_pcs"], batch["piece_id"], nv, np.zeros_like(batch["piece_id"]))
    jout = _np(jit_apply(jm, v, *[jnp.asarray(a) for a in args], train=False))
    with torch.no_grad():
        out = model.eval()(*[torch.from_numpy(np.asarray(a)) for a in args])
    err = np.abs(out["cls_logits"].numpy() - jout["cls_logits"]).max()
    assert err <= 1e-5 * np.abs(jout["cls_logits"]).max()


# ------------------------------------------------------------------ the round trip


@pytest.fixture(scope="module")
def roundtrip(root, tmp_path_factory):
    """The port's matcher trained on the CPU (one epoch of 3 shapes, all three losses, then
    validation and a top-k checkpoint), its matching data written by the writer."""
    out = str(tmp_path_factory.mktemp("mrt"))
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model = ttrain.make_model(**SMALL)
    state = ttrain.train_matching(
        root + "/pc_data/val", out_dir=out + "/train", epochs=1, num_points=RT_PTS,
        mat_epoch=0, rig_epoch=0, model=model, max_num_part=P,
        val_data_dir=root + "/pc_data/val", log_every=1, device="cpu")
    results = tgen.generate_matching_data(state.model, root + "/pc_data/val",
                                          out + "/matching_data", num_points=RT_PTS,
                                          max_num_part=P, device="cpu")
    return out, state, results


def test_train_matching_validates_and_keeps_the_best(root, roundtrip):
    out, state, _ = roundtrip
    assert state.step == 3
    with open(os.path.join(out, "train", "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    assert [r["step"] for r in recs[:3]] == [0, 1, 2]
    assert all(np.isfinite(r[k]) for r in recs[:3] for k in ttrain.METRIC_KEYS)
    assert any(r["rig_loss"] > 0 for r in recs[:3])  # rig_epoch 0: the rigid loss ran
    assert 0.0 <= recs[3]["val_mat_f1"] <= 1.0
    with open(os.path.join(out, "train", "ckpt", "topk.json")) as fh:
        index = json.load(fh)
    assert index["monitor"] == "mat_f1" and list(index["entries"]) == ["step_3"]
    # a second call resumes from the latest checkpoint, with nothing left to train
    again = ttrain.train_matching(
        root + "/pc_data/val", out_dir=out + "/train", epochs=1, num_points=RT_PTS,
        max_num_part=P, model=ttrain.make_model(**SMALL), device="cpu")
    assert again.step == 3
    for n, p in again.model.state_dict().items():
        assert torch.equal(p, state.model.state_dict()[n]), n


def test_writer_schema_matches_the_reference_contract(roundtrip):
    out, _, results = roundtrip
    mdir = out + "/matching_data"
    files = sorted(os.listdir(mdir))
    assert len(files) == 3
    for f in files:
        m = np.load(os.path.join(mdir, f), allow_pickle=True)
        assert set(m.files) == MATCH_KEYS
        edges, n_pcs = m["edges"], m["n_pcs"]
        assert edges.ndim == 2 and edges.shape[1] == 2
        assert m["gt_pcs"].shape == (int(n_pcs.sum()), 3)
        assert m["critical_pcs_idx"].shape == (int(n_pcs.sum()),)
        offsets = np.concatenate([[0], np.cumsum(n_pcs)])
        for i in range(len(n_pcs)):
            local = m["critical_pcs_idx"][offsets[i]:offsets[i] + int(m["n_critical_pcs"][i])]
            assert (local >= 0).all() and (local < n_pcs[i]).all()
        for e in range(len(edges)):
            b, a = int(edges[e, 0]), int(edges[e, 1])
            corr = np.asarray(m["correspondence"][e]).astype(np.int64)
            assert corr.ndim == 2 and corr.shape[1] == 2 and len(corr) >= 3
            assert (corr[:, 0] < m["n_critical_pcs"][a]).all()
            assert (corr[:, 1] < m["n_critical_pcs"][b]).all()
    for r in results:
        g = r["global_transforms"]
        assert g.shape[1:] == (4, 4) and np.isfinite(g).all()
        np.testing.assert_allclose(g[:, 3, :], np.tile([0, 0, 0, 1], (len(g), 1)), atol=1e-6)


def test_engine_serves_the_port_written_matching_data(root, roundtrip, tmp_path):
    """Port-trained matcher -> port-written matching_data -> DenoiserDataset(test) ->
    run_inference on the CPU."""
    out = roundtrip[0]
    ds = DenoiserDataset(root + "/pc_data/val", mode="test",
                         matching_data_path=out + "/matching_data", max_num_part=P,
                         max_corr=32, max_edges_dense=20)
    assert len(ds) == 3
    batch = next(iter(Loader(ds, 3, shuffle=False, drop_last=False)))
    assert batch["match_edge_valid"].any()
    assert (batch["corr_count"][batch["match_edge_valid"]] >= 3).all()
    cfg = R.Config()
    cfg.data.max_num_part = P
    cfg.data.num_pc_points = 96
    cfg.data.data_val_dir = root + "/pc_data/val"
    cfg.data.matching_data_path = out + "/matching_data"
    cfg.denoiser.embed_dim, cfg.denoiser.num_layers, cfg.denoiser.num_heads = 32, 1, 2
    cfg.verifier.embed_dim, cfg.verifier.num_layers, cfg.verifier.num_heads = 32, 1, 2
    cfg.verifier.max_iters = 2
    cfg.inference.batch_size = 3
    cfg.trainer.output_dir = str(tmp_path)
    _, den, ver = R.make_models(cfg)
    vq = VQVAE(32, 16, 25, 64, sa_npoints=(24, 12), sa_nsamples=(8, 8, 8))
    agg = R.run_inference(cfg, engine=R.build_engine_fn(cfg, "cpu", models=(vq, den, ver)))
    assert agg["num_samples"] == 3
    for k in R.METRIC_KEYS:
        assert np.isfinite(agg[f"eval/{k}"]), k


def test_eval_entry_writes_the_same_files_from_the_checkpoint(root, roundtrip, tmp_path,
                                                            monkeypatch):
    """The entry loads the trained checkpoint and writes what ``generate_matching_data``
    wrote from the trained model. The entry builds the reference's sa_npoints (1024, 256,
    64, 16), which a 160-point cloud cannot take, so the test hands it the small model's."""
    out = roundtrip[0]
    monkeypatch.setattr(ttrain, "make_model", functools.partial(ttrain.make_model, **SMALL))
    meval.main([f"data_dir={root}/pc_data/val", f"ckpt={out}/train/ckpt/best",
                f"out_dir={tmp_path}/m", "pc_feat_dim=32", "aff_feat_dim=16",
                f"num_points={RT_PTS}", f"max_num_part={P}", "--cpu"])
    for name in sorted(os.listdir(out + "/matching_data")):
        a = np.load(os.path.join(out, "matching_data", name), allow_pickle=True)
        b = np.load(os.path.join(str(tmp_path), "m", name), allow_pickle=True)
        for k in a.files:
            if a[k].dtype == object:
                assert all(np.array_equal(x, y) for x, y in zip(a[k], b[k])), k
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    stats = meval.main([f"data_dir={root}/pc_data/val", "oracle=1", f"num_points={RT_PTS}",
                        f"max_num_part={P}"])
    assert stats == oracle_matching_stats(root + "/pc_data/val", num_points=RT_PTS,
                                          max_num_part=P)


def test_matching_entries_need_cuda_unless_cpu_asked(root, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.train_matching(root + "/pc_data/val", out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        meval.main([f"data_dir={root}/pc_data/val", f"ckpt={tmp_path}"])
