"""The port's Jigsaw matcher against the benchmark's plain reference
(``pfpp_bench/reference/matcher.py``), on the CPU at a small size: 6 shapes of 2-5 parts, 256
points a shape, batches of 2, ``sa_npoints`` (64, 32, 16, 8), 32 / 16 features, seeded
weights (``reference/matcher_params.py``). The matcher cell's check holds the same pair at
the published widths on the card (``pfpp_bench/drivers/matcher_train.py``).

Tolerances and why:
  * the batches: equal, array for array (the same numpy on the same files and seed).
  * the fracture labels and the critical counts: equal (the same distance products).
  * the forward's classifier logits and each shape's Sinkhorn matrix, and every loss of the
    first step (the rigid loss on): 1e-5 of the largest entry, relative for a loss. They
    agree to 3e-7 (the program's products are batched where the reference's are per shape
    or per piece pair); Sinkhorn at 19 iterations moves the matrix by 4e-3, at tau 0.1 by
    0.3, and the unbiased variance in the BatchNorms by 5e-2 (the logits by 3e-2).
  * every leaf's gradient: 1e-4 of the larger of its own norm and its block's largest
    weight gradient entry, in L2 norm; they agree to 5e-6 (``training/parity.py`` says why
    the matcher's gradients are held in norm).
  * Adam under the cosine factor: three updates from the same gradients, 1e-3 of lr
    (float32's spacing at the weights' magnitude is 6e-8 = 6e-5 of lr; a factor off by one
    step moves the second update by 0.15 lr).
    Whole steps are not compared past the first: Adam's first update moves every entry by
    about lr whatever its gradient's size, so an entry whose gradient is float noise moves
    either way, and at this size a 1e-7 perturbation of the weights moves the second step's
    loss by 1e-2 (``test_second_step_is_ill_conditioned``).
  * the spans: one step under a profiler records each ``pfpp.match.*`` span once and the
    syncs PERF.md lists; neither the profiler nor the spans change a bit of the step.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os

import numpy as np
import pytest
import torch

from pfpp_bench import harness
from pfpp_bench.drivers import matcher_train as drv
from pfpp_bench.reference import matcher as R
from pfpp_bench.reference import matcher_params as MP
from pfpp_bench.traffic import shapes
from puzzlefusion_plusplus_tpu_torch.matching import model as tmodel
from puzzlefusion_plusplus_tpu_torch.matching import ops as mops
from puzzlefusion_plusplus_tpu_torch.matching import train as T
from puzzlefusion_plusplus_tpu_torch.training.state import adam_cosine
from puzzlefusion_plusplus_tpu_torch.training.vqvae import local_rows
from puzzlefusion_plusplus_tpu_torch.utils import profiling

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, LOADER_SEED, DECAY = 2147483999, 77, 750
CPU = torch.device("cpu")
FWD_TOL, GRAD_TOL, ADAM_TOL = 1e-5, 1e-4, 1e-3
SYNCS_A_STEP = {"pfpp.sync.match_batch": 10, "pfpp.sync.bn_count": 37}


def small_cfg(w_rig: float = 1.0) -> dict:
    with open(os.path.join(REPO, "pfpp_bench", "configs",
                           "jigsaw_everyday_matcher_train.json")) as fh:
        cfg = json.load(fh)
    cfg["model"].update(pc_feat_dim=32, aff_feat_dim=16, sa_npoints=[64, 32, 16, 8])
    cfg["data"].update(num_points=256, max_num_part=5, points_per_part=128)
    cfg["train"].update(batch_size=2, w_rig=w_rig)
    return cfg


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("matcher_plain") / "train")
    shapes.write_train_set({"part_draw": {"low": 2, "high": 5, "shapes": 6}}, SEED, 128, d,
                           1).get()
    return d


def program(cfg: dict, data_dir: str):
    """(loader, state) of the program at the seed's weights."""
    model = harness.load(drv.program_model(cfg, CPU), MP.draw(cfg["model"], SEED, CPU))
    d, tr = cfg["data"], cfg["train"]
    loader, _, state = T._setup(data_dir, d["num_points"], d["max_num_part"], tr["batch_size"],
                                LOADER_SEED, None, model, 250, tr["lr"], CPU)
    return loader, state


@pytest.fixture(scope="module")
def first(data_dir):
    """The first batch through the program's train-mode forward and loss (rigid loss on)
    and the reference's, with every leaf's gradient."""
    cfg = small_cfg()
    loader, state = program(cfg, data_dir)
    batch = local_rows(next(iter(loader)), CPU)
    state.model.train()
    loss, metrics, out, _, _ = T.loss_fn(state.model, batch, 1.0, 1.0)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
    rb = R.MatcherData(data_dir, cfg["data"]).batches(LOADER_SEED, 2, 1)[0]
    p = {k: v.requires_grad_(True) for k, v in MP.draw(cfg["model"], SEED, CPU).items()
         if not k.endswith(("running_mean", "running_var"))}
    ref = R.forward(p, cfg, {k: torch.as_tensor(v) for k, v in rb.items()})
    ref["loss"].backward()
    return {"cfg": cfg, "batch": batch, "metrics": metrics, "out": out, "grads": grads,
            "ref": ref, "ref_grads": {n: v.grad for n, v in p.items()}, "ref_batch": rb}


def test_batches_equal_the_loaders(data_dir):
    cfg = small_cfg()
    loader, _ = program(cfg, data_dir)
    ours = list(loader)[:3]
    theirs = R.MatcherData(data_dir, cfg["data"]).batches(LOADER_SEED, 2, 3)
    for a, b in zip(ours, theirs):
        for k, k2 in (("part_pcs", "part_pcs"), ("gt_pcs", "gt_pcs"), ("piece_id", "piece_id"),
                      ("part_valids", "part_valids"), ("critical_label_thresholds", "thresholds")):
            np.testing.assert_array_equal(a[k], b[k2])


def test_labels_and_critical_counts_equal(first):
    b = first["batch"]
    labels = mops.fracture_point_labels(b["gt_pcs"], b["piece_id"],
                                        b["part_valids"].sum(-1).to(torch.int32),
                                        b["critical_label_thresholds"])
    assert torch.equal(labels.bool(), first["ref"]["labels"])
    assert first["out"]["n_critical_sum"].tolist() == first["ref"]["n_crit"].tolist()
    assert min(first["ref"]["n_crit"].tolist()) > 0


def _blocks(out) -> list:
    return [out["ds_mat"][i, :n, :n].detach() for i, n in enumerate(out["n_critical_sum"].tolist())]


def ds_gap(ds, ref_ds) -> float:
    return max(float((a - b.detach()).abs().max()) for a, b in zip(ds, ref_ds))


def test_forward_cls_logits_match_plain(first):
    a, b = first["out"]["cls_logits"].detach(), first["ref"]["cls_logits"].detach()
    assert float((a - b).abs().max()) <= FWD_TOL * float(b.abs().max())


def test_forward_sinkhorn_matches_plain(first):
    assert ds_gap(_blocks(first["out"]), first["ref"]["ds"]) <= FWD_TOL


@pytest.mark.parametrize("name", ["cls_loss", "mat_loss", "rig_loss", "loss"])
def test_losses_match_plain(first, name):
    ours, ref = float(first["metrics"][name]), float(first["ref"][name])
    assert ref > 0
    assert abs(ours - ref) <= FWD_TOL * abs(ref), (ours, ref)


BLOCKS = ("encoder.sa", "encoder.fp", "encoder.conv1", "encoder.bn1", "tf_self1", "tf_cross1",
          "cls_", "aff_", "affinity_layer")


def grad_gaps(grads: dict, ref: dict, prefix: str) -> dict:
    """Each leaf's |g - g_ref| in L2 over its block's largest weight gradient entry (the
    gradient of a bias ahead of a BatchNorm is float noise: its scale is its block's)."""
    names = [n for n in ref if n.startswith(prefix)]
    scale = max(float(ref[n].abs().max()) for n in names if n.endswith("weight") or
                n.endswith(".A"))
    return {n: float(torch.linalg.vector_norm(grads[n] - ref[n]))
            / max(float(torch.linalg.vector_norm(ref[n])), scale) for n in names}


@pytest.mark.parametrize("prefix", BLOCKS)
def test_gradients_match_plain(first, prefix):
    gaps = grad_gaps(first["grads"], first["ref_grads"], prefix)
    assert gaps and max(gaps.values()) <= GRAD_TOL, max(gaps.items(), key=lambda kv: kv[1])


def test_every_leaf_is_held(first):
    assert set(first["grads"]) == set(first["ref_grads"])
    assert all(any(n.startswith(b) for b in BLOCKS) for n in first["grads"])


def test_adam_cosine_steps_match_plain(first):
    """Three updates from the first step's gradients (and their halves, then doubles)."""
    model = torch.nn.Module()
    ours = {n: torch.nn.Parameter(v.detach().clone())
            for n, v in MP.draw(first["cfg"]["model"], SEED, CPU).items() if n in first["grads"]}
    for n, v in ours.items():
        model.register_parameter(n.replace(".", "_"), v)
    state = adam_cosine(model, 1e-3, 4)
    ref = {n: v.detach().clone() for n, v in ours.items()}
    adam_state = {}
    for k, scale in enumerate((1.0, 0.5, 2.0)):
        for n, v in ours.items():
            v.grad = first["grads"][n] * scale
        state.optimizer.step()
        state.scheduler.step()
        R.adam(ref, {n: first["grads"][n] * scale for n in ref}, adam_state, k + 1,
               1e-3 * R.cosine_factor(k, 4), (0.9, 0.999), 1e-8)
    for n, v in ours.items():
        assert float((v.detach() - ref[n]).abs().max()) <= ADAM_TOL * 1e-3, n


def test_second_step_is_ill_conditioned(data_dir):
    """The reference alone from weights moved by 1e-7 relative: the first step's loss
    moves by under 1e-5, the second's by over 1e-3."""
    cfg = small_cfg(w_rig=0.0)
    batches = R.MatcherData(data_dir, cfg["data"]).batches(LOADER_SEED, 2, 2)
    p0 = MP.draw(cfg["model"], SEED, CPU)
    g = torch.Generator().manual_seed(5)
    p1 = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=g)) for k, v in p0.items()}
    a, b = R.steps(p0, cfg, batches, DECAY, CPU), R.steps(p1, cfg, batches, DECAY, CPU)
    gaps = [abs(x - y) / abs(x) for x, y in zip(a["loss"], b["loss"])]
    assert gaps[0] < 1e-5 < 1e-3 < gaps[1], gaps


def _unbiased_bn(p, name, x, weights=None):
    red = tuple(range(x.dim() - 1))
    var = x.var(red, unbiased=True)
    return (x - x.mean(red)) * torch.rsqrt(var + R.BN_EPS) * p[f"{name}.weight"] + p[f"{name}.bias"]


FAULTS = {"sinkhorn_19_iterations": ({"sinkhorn_iters": 19}, None),
          "sinkhorn_tau_0.1": ({"sinkhorn_tau": 0.1}, None),
          "batchnorm_unbiased_variance": ({}, _unbiased_bn)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_tolerances_fail_a_planted_fault(first, fault, monkeypatch):
    override, bn = FAULTS[fault]
    cfg = copy.deepcopy(first["cfg"])
    cfg["model"].update(override)
    if bn is not None:
        monkeypatch.setattr(R, "batch_norm", bn)
    p = MP.draw(cfg["model"], SEED, CPU)
    with torch.no_grad():
        ref = R.forward(p, cfg, {k: torch.as_tensor(v) for k, v in first["ref_batch"].items()})
    gap_ds = ds_gap(_blocks(first["out"]), ref["ds"])
    a, b = first["out"]["cls_logits"].detach(), ref["cls_logits"]
    gap_logits = float((a - b).abs().max()) / float(b.abs().max())
    assert max(gap_ds, gap_logits) > 10 * FWD_TOL, (gap_ds, gap_logits)


def _step(data_dir: str):
    """One program step on the first batch -> (metrics, parameters after)."""
    loader, state = program(small_cfg(), data_dir)
    metrics = T.train_step(state, local_rows(next(iter(loader)), CPU), 1.0, 1.0)
    return metrics, {n: p.detach().clone() for n, p in state.model.named_parameters()}


MATCH_SPANS = ("pfpp.match.step", "pfpp.match.loss", "pfpp.match.encode", "pfpp.match.attention",
               "pfpp.match.affinity", "pfpp.match.sinkhorn", "pfpp.match.backward",
               "pfpp.match.optimizer")


def test_one_step_records_each_span_once(data_dir):
    loader, state = program(small_cfg(), data_dir)
    batch = next(iter(loader))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        T.train_step(state, T.device_batch(batch, CPU), 1.0, 1.0)
    spans = profiling.snapshot()["spans"]
    assert {n: spans.get(n, {}).get("count", 0) for n in MATCH_SPANS} == dict.fromkeys(
        MATCH_SPANS, 1)
    syncs = {n: v["count"] for n, v in spans.items() if n.startswith("pfpp.sync.")}
    assert syncs == SYNCS_A_STEP, syncs


@pytest.mark.parametrize("how", ["profiled", "spans_removed"])
def test_spans_leave_the_step_bit_equal(data_dir, how, monkeypatch):
    base_metrics, base_params = _step(data_dir)
    if how == "profiled":
        ctx = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    else:  # the step as it was before the spans
        for mod in (T, tmodel):
            monkeypatch.setattr(mod.profiling, "span", lambda *a, **k: contextlib.nullcontext())
        ctx = contextlib.nullcontext()
    with ctx:
        metrics, params = _step(data_dir)
    for k, v in base_metrics.items():
        assert torch.equal(v, metrics[k]), k
    for n, v in base_params.items():
        assert torch.equal(v, params[n]), n
