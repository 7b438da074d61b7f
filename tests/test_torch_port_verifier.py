"""Parity of the port's verifier stage with the JAX package, on the CPU: the verifier
dataset, loss, metrics, gradients and one AdamW step, verifier-data generation (where kernel
N runs its plain version), the trainer entry, and the loader's prefetch thread.

Tolerances and why:
  * VerifierDataset: every field exact (the same numpy arithmetic on the same files).
  * loss_fn: loss 1e-5 relative; the binary metrics exact (the fixture's logits are checked
    to sit more than 1e-3 from 0, so both sides predict the same classes); every gradient
    within 1e-4 of its largest entry plus 1e-7 (the two frameworks sum the attention and the
    GEMMs in other orders). Dropout is off on both sides (their masks cannot agree), so the
    JAX step is the package's ``train_step`` with ``train=False``.
  * train_step: the parameters after one AdamW step within 1e-6 where the gradient exceeds
    1e-4 of its largest entry, elsewhere within 2 lr (Adam's first step is about
    lr * sign(g)). The key projection's bias has true gradient 0 (a query's scores all move
    by one constant, which the softmax removes): its gradient must stay below 1e-5 of its
    kernel's largest entry, and its parameters within 2 lr.
  * generate_verifier_data, with the same injected poses on both sides: ``cls_gt`` and
    ``edge_indices`` exact; ``edge_features`` exact except for points whose per-point
    distance lies within 1e-4 relative of a histogram bin edge (none in this fixture, which
    the test checks). The part labels come from each side's chamfer: the JAX package's CPU
    chamfer uses the expanded |x|^2 - 2xy + |y|^2 form and the port direct differences
    (ROADMAP §3), so the fixture keeps its parts either exactly at the ground truth (CD 0)
    or far from it (CD above 10x the 0.01 bar).
  * prefetch_batches: batches bit-equal to plain iteration.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.helpers import jit_init

from puzzlefusion_plusplus_tpu.convert.torch_ckpt import convert_verifier
from puzzlefusion_plusplus_tpu.data import generate_dataset as jgen
from puzzlefusion_plusplus_tpu.data.datasets import VerifierDataset as JVDS
from puzzlefusion_plusplus_tpu.data.loader import Loader as JLoader
from puzzlefusion_plusplus_tpu.data.verifier_gen import generate_verifier_data as jgenerate
from puzzlefusion_plusplus_tpu.models.verifier import VerifierTransformer as JVer
from puzzlefusion_plusplus_tpu.training import state as jstate
from puzzlefusion_plusplus_tpu.training import verifier as jtrain
from puzzlefusion_plusplus_tpu_torch.convert import from_jax
from puzzlefusion_plusplus_tpu_torch.data import (
    Loader,
    VerifierDataset,
    VQVAEDataset,
    generate_dataset,
    prefetch_batches,
)
from puzzlefusion_plusplus_tpu_torch.data import verifier_gen
from puzzlefusion_plusplus_tpu_torch.models.verifier import VerifierTransformer as TVer
from puzzlefusion_plusplus_tpu_torch.training import parity
from puzzlefusion_plusplus_tpu_torch.training import state as tstate
from puzzlefusion_plusplus_tpu_torch.training import verifier as ttrain
from puzzlefusion_plusplus_tpu_torch.utils.config import Config, apply_overrides
from puzzlefusion_plusplus_tpu_torch.utils.transforms import quat_apply_raw

torch.set_num_threads(2)

B_, E_, NODES = 3, 15, 6
VER_KW = dict(embed_dim=32, num_layers=2, num_heads=2, max_nodes=NODES, ff_dim=64)
BIN_EDGES = np.array([0, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 100])


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _port_ver(params, dropout=0.0):
    m = TVer(32, 2, 2, max_nodes=NODES, ff_dim=64, dropout=dropout)
    m.load_state_dict(from_jax.verifier_state_dict(params))
    return m


@pytest.fixture(scope="module")
def setup():
    """A small verifier, a batch of 3 with padded edges and both classes."""
    model = JVer(**VER_KW)
    v = jit_init(model, jax.random.key(2), jnp.zeros((1, E_, 7)),
                 jnp.zeros((1, E_, 2), jnp.int32), jnp.ones((1, E_)), train=False)
    rng = np.random.default_rng(30)
    valids = np.ones((B_, E_), np.float32)
    valids[1, 9:] = 0
    valids[2, 4:] = 0
    batch = {
        "edge_features": rng.random((B_, E_, 7)).astype(np.float32),
        "edge_indices": np.stack(np.triu_indices(NODES, 1), -1)[None].repeat(B_, 0)
        .astype(np.int64),
        "edge_valids": valids,
        "cls_gt": (rng.random((B_, E_)) < 0.4).astype(np.float32) * valids,
    }
    return dict(model=model, params=_np_tree(v["params"]), batch=batch)


def _jbatch(batch):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in batch.items()}


def _grad_tree(model):
    return convert_verifier({n: p.grad for n, p in model.named_parameters()})["params"]


def _assert_trees_close(out, ref, rel, atol):
    for path, r in jax.tree_util.tree_leaves_with_path(ref):
        o = out
        for key in path:
            o = o[key.key]
        err = float(np.abs(np.asarray(o) - r).max())
        assert err <= rel * float(np.abs(r).max()) + atol, jax.tree_util.keystr(path)


# ------------------------------------------------------------------ data


def _verifier_files(root):
    jgen(root, num_shapes=7, seed=31, split="train", min_parts=2, max_parts=6, n_points=64)
    return root + "/verifier_data"


@pytest.mark.parametrize("mode,overfit", [("train", -1), ("val", -1), ("train", 4)])
def test_verifier_dataset_matches_jax(tmp_path, mode, overfit):
    data_dir = _verifier_files(str(tmp_path))
    jds, tds = JVDS(data_dir, mode, overfit), VerifierDataset(data_dir, mode, overfit)
    assert len(tds) == len(jds) == {("train", -1): 5, ("val", -1): 2, ("train", 4): 3}[
        (mode, overfit)]
    ref = list(JLoader(jds, 2, seed=3, drop_last=False))
    out = list(Loader(tds, 2, seed=3, drop_last=False))
    assert len(out) == len(ref)
    for ob, rb in zip(out, ref):
        assert set(ob) == set(rb)
        for k in rb:
            np.testing.assert_array_equal(ob[k], rb[k], err_msg=k)
    assert out[0]["edge_features"].shape[1:] == (190, 7)


def test_prefetch_batches_matches_plain_iteration(tmp_path):
    """The same batches as plain iteration; a consumer that leaves early stops the
    producer; a producer's exception re-raises at the consumer."""
    root = str(tmp_path)
    generate_dataset(root, num_shapes=6, seed=2, split="train", min_parts=2, max_parts=3,
                     n_points=64, with_matching=False, with_verifier=False)
    ds = VQVAEDataset(root + "/pc_data/train", max_num_part=4)
    plain = list(Loader(ds, 2, seed=5))
    pref = list(prefetch_batches(Loader(ds, 2, seed=5), depth=2))
    assert len(plain) == len(pref) == 3
    for a, b in zip(plain, pref):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    gen = prefetch_batches(Loader(ds, 2, seed=5), depth=1)
    next(gen)
    gen.close()

    def boom():
        yield {"x": np.zeros(1)}
        raise RuntimeError("producer failed")

    it = prefetch_batches(boom(), depth=2)
    next(it)
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)


def test_prefetch_batches_slow_consumer_terminates():
    """The queue is full when the producer ends; the end marker must still arrive, also
    on the error path."""
    got: list[int] = []

    def consume():
        for item in prefetch_batches(iter(range(6)), depth=1):
            time.sleep(0.05)
            got.append(item)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "prefetch_batches hung at the producer's end"
    assert got == list(range(6))

    def failing():
        yield from range(3)
        raise ValueError("late failure")

    seen, caught = [], []

    def consume_failing():
        try:
            for item in prefetch_batches(failing(), depth=1):
                time.sleep(0.05)
                seen.append(item)
        except ValueError as e:
            caught.append(e)

    t = threading.Thread(target=consume_failing, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen == [0, 1, 2] and len(caught) == 1


# ------------------------------------------------------------------ model and loss


def test_loss_metrics_and_every_gradient_match_jax(setup):
    s = setup
    (jloss, jm), jgrads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        s["params"], s["model"], _jbatch(s["batch"]), 0.2, False)
    model = _port_ver(s["params"]).train()  # no dropout: train mode computes as eval
    batch = {k: T(v) for k, v in s["batch"].items()}
    with torch.no_grad():
        logits = model(batch["edge_features"], batch["edge_indices"], batch["edge_valids"])
    assert float(logits.abs().min()) > 1e-3
    loss, metrics = ttrain.loss_fn(model, batch, 0.2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(metrics) == set(jm) == set(ttrain.METRIC_KEYS)
    for k in ttrain.METRIC_KEYS[1:]:
        assert float(metrics[k]) == pytest.approx(float(jm[k]), abs=1e-7), k
    assert 0 < float(metrics["cls_acc"]) < 1
    _assert_trees_close(_grad_tree(model), _np_tree(jgrads), rel=1e-4, atol=1e-7)


@pytest.mark.parametrize("case", ["mixed", "no_positive_prediction", "all_masked"])
def test_binary_cls_metrics_match_jax(case):
    rng = np.random.default_rng(32)
    pred = (rng.random((4, 20)) < 0.5).astype(np.float32)
    gt = (rng.random((4, 20)) < 0.5).astype(np.float32)
    w = (rng.random((4, 20)) < 0.8).astype(np.float32)
    if case == "no_positive_prediction":
        pred[:] = 0
    elif case == "all_masked":
        w[:] = 0
    ref = jtrain.binary_cls_metrics(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(w))
    out = ttrain.binary_cls_metrics(T(pred), T(gt), T(w))
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-6, atol=1e-9,
                                   err_msg=k)


def test_train_step_matches_jax(setup):
    s = setup
    lr = 2e-4
    tx = jstate.adamw_reference(lr, 0.95, 0.999, 1e-6)
    (_, jm), jgrads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        s["params"], s["model"], _jbatch(s["batch"]), 0.2, False)
    params = jax.tree.map(jnp.asarray, s["params"])
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = _np_tree(optax.apply_updates(params, updates))
    model = _port_ver(s["params"])
    state = tstate.adamw_reference(model, lr, 0.95, 0.999, 1e-6)
    metrics = ttrain.train_step(state, {k: T(v) for k, v in s["batch"].items()}, 0.2)
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["cls_loss"]), float(jm["cls_loss"]), rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(convert_verifier(model.state_dict())["params"]))
    grads = dict(jax.tree_util.tree_leaves_with_path(_np_tree(jgrads)))
    for path, ref in jax.tree_util.tree_leaves_with_path(jnew):
        name = jax.tree_util.keystr(path)
        g = np.abs(grads[path])
        err = np.abs(np.asarray(got[path]) - ref)
        if name.endswith("['k_proj']['bias']"):
            # the key bias shifts a query's scores by one constant, which the softmax
            # removes: its true gradient is 0 and both sides hold float noise
            kernel = np.abs(grads[path[:-1] + (jax.tree_util.DictKey("kernel"),)]).max()
            assert g.max() <= 1e-5 * kernel, name
        else:
            assert err[g > 1e-4 * g.max()].max(initial=0) <= 1e-6, name
        assert err.max() <= 2 * lr + 1e-6, name


def _parent_forward(model, feats, idx, valids):
    """The eval-mode forward as it was before dropout was added."""
    from puzzlefusion_plusplus_tpu_torch.models.denoiser import NEG_INF, attention

    B, E, _ = idx.shape
    x = model.pe[idx.long()].reshape(B, E, model.embed_dim) + model.edge_feature_emb(feats)
    bias = torch.where(valids.bool(), torch.zeros(()), torch.full((), NEG_INF))[:, None, None]
    for layer in model.transformer_encoder.layers:
        a = layer.self_attn
        q, k, v = torch.nn.functional.linear(x, a.in_proj_weight, a.in_proj_bias).chunk(3, -1)
        x = layer.norm1(x + a.out_proj(attention(q, k, v, a.heads, bias)))
        ff = layer.linear2(torch.nn.functional.gelu(layer.linear1(x)))
        x = layer.norm2(x + ff)
    return model.mlp_out(x)


def test_verifier_dropout_is_train_mode_only(setup):
    """Dropout carries no parameters and draws nothing at construction; it acts in train
    mode only, and the eval-mode forward is the parent's bit for bit."""
    s = setup
    torch.manual_seed(0)
    a = TVer(32, 2, 2, max_nodes=NODES, ff_dim=64)
    torch.manual_seed(0)
    b = TVer(32, 2, 2, max_nodes=NODES, ff_dim=64, dropout=0.0)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    m = _port_ver(s["params"], dropout=0.5)
    args = [T(s["batch"][k]) for k in ("edge_features", "edge_indices", "edge_valids")]
    with torch.no_grad():
        ref = _parent_forward(m, *args)
        assert torch.equal(m.eval()(*args), ref)
        assert torch.equal(_port_ver(s["params"]).train()(*args), ref)
        assert not torch.allclose(m.train()(*args), ref)
    layer = m.transformer_encoder.layers[0]
    assert [type(d).__name__ for d in (layer.dropout, layer.dropout1, layer.dropout2)] == [
        "Dropout"] * 3
    assert layer.self_attn.dropout == 0.5
    assert ttrain.make_model(Config()).transformer_encoder.layers[0].dropout.p == 0.1


def test_device_parity_check_accepts_equal_verifier_steps_and_catches_a_missing_gradient(
        setup):
    """``training/parity.py``'s verifier step, both sides on the CPU; a zeroed gradient
    must be named."""
    s = setup
    sd = _port_ver(s["params"]).state_dict()

    def make():
        return TVer(32, 2, 2, max_nodes=NODES, ff_dim=64, dropout=0.0)

    ref = parity.verifier_step_on(make, sd, s["batch"], "cpu")
    errs = parity.compare(ref, parity.verifier_step_on(make, sd, s["batch"], "cpu"),
                          ("cls_loss",))
    assert errs["grad_max_rel"] == 0.0 and errs["param_after_step_any"] == 0.0
    name = "transformer_encoder.layers.1.linear1.weight"
    bad = {**ref, "grads": {**ref["grads"], name: torch.zeros_like(ref["grads"][name])}}
    with pytest.raises(AssertionError, match=name):
        parity.compare(ref, bad, ("cls_loss",))


# ------------------------------------------------------------------ verifier-data generation


OFF_QUAT = np.array([0.5, 0.5, -0.5, 0.5], np.float32)


def _fixed_poses(trans, rots, xp):
    """Even parts at their ground-truth pose, odd parts turned and moved well off it."""
    P = trans.shape[1]
    off = (xp.arange(P) % 2 == 1)[None, :, None]
    t = xp.where(off, trans + 0.4, trans)
    q = xp.where(off, xp.asarray(OFF_QUAT)[None, None], rots)
    return xp.concatenate([t, q], -1)


def _near_bin_edges(batch, final):
    """Per-point distances of the edge histograms within 1e-4 relative of a bin edge."""
    f = T(final[0])
    area = (quat_apply_raw(f[:, None, 3:], T(batch["area_pts"][0])) + f[:, None, :3]).numpy()
    near = 0
    for e in np.flatnonzero(batch["match_edge_valid"][0]):
        k = int(batch["corr_count"][0, e])
        i2, i1 = batch["match_edges"][0, e]
        src = area[i1, batch["corr_src"][0, e, :k]]
        tgt = area[i2, batch["corr_tgt"][0, e, :k]]
        d = ((src[:, None] - tgt[None]) ** 2).sum(-1)
        per = d.min(1) + d.min(0)
        near += int((np.abs(per[:, None] - BIN_EDGES[1:]) <= 1e-4 * BIN_EDGES[1:]).sum())
    return near


def test_generate_verifier_data_matches_jax(tmp_path):
    root = str(tmp_path)
    jgen(root, num_shapes=3, seed=33, split="train", min_parts=3, max_parts=5, n_points=96,
         with_verifier=False)
    P = 6
    kw = dict(max_num_part=P, rounds=2, seed=4)
    n_j = jgenerate(
        lambda params, b, rng: (_fixed_poses(b["part_trans"], b["part_rots"], jnp), None),
        None, root + "/pc_data/train", root + "/matching_data", root + "/jax_out", **kw)
    n_t = verifier_gen.generate_verifier_data(
        lambda b, gen: (_fixed_poses(b["part_trans"], b["part_rots"], torch), None),
        root + "/pc_data/train", root + "/matching_data", root + "/port_out", device="cpu",
        **kw)
    assert n_j == n_t == 6
    names = sorted(os.listdir(root + "/jax_out"))
    assert names == sorted(os.listdir(root + "/port_out")) and names[1].endswith("_1.npz")
    from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset

    ds = DenoiserDataset(root + "/pc_data/train", mode="test",
                         matching_data_path=root + "/matching_data", max_num_part=P)
    batches = list(Loader(ds, 1, shuffle=False, drop_last=False, seed=4))
    both = 0
    for name in names:
        a, b = np.load(f"{root}/jax_out/{name}"), np.load(f"{root}/port_out/{name}")
        assert a.files == b.files == ["cls_gt", "edge_features", "edge_indices"]
        assert a["edge_features"].dtype == b["edge_features"].dtype == np.float32
        np.testing.assert_array_equal(b["cls_gt"], a["cls_gt"])
        np.testing.assert_array_equal(b["edge_indices"], a["edge_indices"])
        batch = next(x for x in batches if f"{int(x['data_id'][0]):05d}" == name[:5])
        final = _fixed_poses(batch["part_trans"], batch["part_rots"], np)
        assert _near_bin_edges(batch, final) == 0
        np.testing.assert_array_equal(b["edge_features"], a["edge_features"])
        both += int(b["cls_gt"].sum())
        assert (b["cls_gt"] == 0).any()  # an edge with an off part
    assert both > 0  # edges between two parts at the ground truth
    assert VerifierDataset(root + "/port_out", "train").get(0, None)["edge_features"].shape == (
        190, 7)


# ------------------------------------------------------------------ the trainer


def _tiny_cfg(root):
    return apply_overrides(Config(), [
        f"data.verifier_data_path={root}/verifier_data", "data.batch_size=2",
        "data.val_batch_size=2", "verifier.embed_dim=32", "verifier.num_layers=1",
        "verifier.num_heads=2", "verifier.epochs=2", "trainer.ckpt_every_epochs=1",
        "trainer.log_every=1", f"trainer.output_dir={root}/out",
    ])


def test_trainer_runs_on_cpu_and_needs_cuda_otherwise(tmp_path, monkeypatch):
    """Two epochs of two steps, each validated, then a resume that continues the step
    count; without CUDA the entry raises unless asked for the CPU."""
    root = str(tmp_path)
    generate_dataset(root, num_shapes=6, seed=34, split="train", min_parts=2, max_parts=5,
                     n_points=64)
    cfg = _tiny_cfg(root)
    state = ttrain.train(cfg, device="cpu")
    assert state.step == 4
    out = os.path.join(root, "out", "everyday", "verifier")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1, 2, 2, 3, 4]
    assert all(np.isfinite(recs[i]["cls_loss"]) for i in (0, 1, 3, 4))
    assert all(np.isfinite(recs[i][f"val_{k}"]) for i in (2, 5) for k in ttrain.METRIC_KEYS)
    ckpts = sorted(os.listdir(os.path.join(out, "ckpt")))
    assert ckpts == ["step_2", "step_4", "topk.json"]
    sd = tstate.load_model_state(os.path.join(out, "ckpt", "latest"))
    assert all(torch.equal(v, state.model.state_dict()[k].cpu()) for k, v in sd.items())
    cfg.verifier.epochs = 3
    assert ttrain.train(cfg, max_steps=5, device="cpu").step == 5  # resumed at step 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main([f"data.verifier_data_path={root}/verifier_data"])
    # the JAX verifier trainer reads no precision key: under bf16 it trains in fp32
    cfg.trainer.precision = "bf16"
    state = ttrain.train(cfg, max_steps=6, device="cpu")  # resumed at step 5
    assert state.step == 6
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


@pytest.mark.parametrize("trainer", ["vqvae", "denoiser", "verifier"])
def test_trainers_refuse_more_than_one_device(tmp_path, monkeypatch, trainer):
    """More cards than are visible raise before any work. On the CPU,
    ``trainer.num_devices=2`` trains on two processes (``parallel/launch.py``): 2 steps, one
    checkpoint and one metrics record a step, written by rank 0 alone, and the state
    returned is the checkpoint's."""
    import importlib

    module = importlib.import_module(f"puzzlefusion_plusplus_tpu_torch.training.{trainer}")
    root = str(tmp_path)
    if trainer == "verifier":
        generate_dataset(root, num_shapes=6, seed=34, split="train", min_parts=2,
                         max_parts=5, n_points=64)
        cfg = _tiny_cfg(root)
    else:
        generate_dataset(root, num_shapes=4, seed=11, split="train", min_parts=2,
                         max_parts=4, n_points=1000)
        generate_dataset(root, num_shapes=2, seed=12, split="val", min_parts=2, max_parts=4,
                         n_points=1000)
        cfg = apply_overrides(Config(), [
            f"data.data_dir={root}/pc_data/train", f"data.data_val_dir={root}/pc_data/val",
            "data.batch_size=2", "data.val_batch_size=2", "data.max_num_part=4",
            "ae.n_embeddings=32", "denoiser.embed_dim=32", "denoiser.num_layers=1",
            "denoiser.num_heads=2", "trainer.log_every=1", f"trainer.output_dir={root}/out"])
    cfg.trainer.num_devices = 2
    state = module.train(cfg, max_steps=2, device="cpu", join_timeout_s=120)
    assert state.step == 2
    out = os.path.join(root, "out", "everyday", trainer)
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["step_2"]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1]
    sd = tstate.load_model_state(os.path.join(out, "ckpt", "latest"))
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in sd.items())
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="trainer.num_devices=2 but only 1 CUDA"):
            module.train(cfg, device="cuda")
