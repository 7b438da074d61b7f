"""The port's spans and host-sync counters (``utils/profiling.py``: ``span``, ``sync``,
``snapshot``) at the engine's and the denoiser trainer's layer boundaries, on the CPU.

* With no profiler running the spans record nothing, and the engine's outputs are the same
  bit for bit with and without one.
* Under ``torch.profiler`` an engine call records one ``pfpp.engine.call``, a
  ``pfpp.engine.step`` a denoising step (each with one ``encode`` and one ``denoiser``
  child), the exit checks, merge gates and result fetch that its own ``n_iters`` implies,
  and ``pfpp.engine.merge`` only where a merge fires; the same counts appear as ranges in
  the exported Chrome trace.
* ``prefetch_batches`` records one ``pfpp.loader.build`` (on its producer thread: by host
  clock alone, so not in the trace) and one ``pfpp.loader.wait`` a batch.
* A second profiled session starts the registry afresh; no ``pfpp.`` name is one that the
  benchmark's drivers count as their own spans.
* The denoiser's CUDA-graph dispatch (``DenoiserTransformer.forward``) stays eager on the CPU,
  in ``train()``, with autograd on, with a forward hook and with a DTensor parameter, and
  then equals its eager body bit for bit; its key follows the parameters' addresses; no
  ``pfpp.denoiser.*`` span is recorded on the CPU. The graph path itself runs on the card
  (``tests/test_torch_port_cuda.py``).
"""

import itertools
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.modules import module as nn_module

from puzzlefusion_plusplus_tpu_torch.data import DenoiserDataset, Loader, generate_dataset
from puzzlefusion_plusplus_tpu_torch.data.loader import prefetch_batches
from puzzlefusion_plusplus_tpu_torch.inference import run as R
from puzzlefusion_plusplus_tpu_torch.inference.sampler import make_frozen_encoder
from puzzlefusion_plusplus_tpu_torch.models.denoiser import DenoiserTransformer
from puzzlefusion_plusplus_tpu_torch.models.scheduler import DDPMParams
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE
from puzzlefusion_plusplus_tpu_torch.training import denoiser as ttrain
from puzzlefusion_plusplus_tpu_torch.utils import profiling

torch.set_num_threads(2)
STEPS = 3  # denoising steps an iteration


def _vqvae():
    torch.manual_seed(0)
    return VQVAE(32, 16, 25, 64, sa_npoints=(24, 12), sa_nsamples=(8, 8, 8))


def _cfg(root, max_iters, threshold=0.9):
    cfg = R.Config()
    cfg.data.max_num_part = 5
    cfg.data.data_dir = root + "/pc_data/train"
    cfg.data.data_val_dir = root + "/pc_data/val"
    cfg.data.matching_data_path = root + "/matching_data"
    cfg.data.batch_size = 2
    for sub in (cfg.denoiser, cfg.verifier):
        sub.embed_dim, sub.num_layers, sub.num_heads = 32, 1, 2
    cfg.denoiser.num_inference_steps = STEPS
    cfg.verifier.max_iters = max_iters
    cfg.verifier.threshold = threshold
    return cfg


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tracing"))
    for split, seed in (("val", 4), ("train", 5)):
        generate_dataset(root, num_shapes=4, seed=seed, split=split, min_parts=3, max_parts=5,
                         n_points=96)
    return root


def _engine(root, max_iters, threshold=0.9):
    cfg = _cfg(root, max_iters, threshold)
    _, den, ver = R.make_models(cfg)
    return R.build_engine_fn(cfg, "cpu", models=(_vqvae(), den, ver))


def _batch(root, forced=False):
    ds = DenoiserDataset(root + "/pc_data/val", mode="test",
                         matching_data_path=root + "/matching_data", max_num_part=5)
    batch = next(iter(Loader(ds, 2, shuffle=False, drop_last=False)))
    if forced:  # no reference part: with threshold 0 every valid edge merges
        batch = dict(batch, ref_part=np.zeros_like(batch["ref_part"]))
    return batch


def _call(engine, batch, seed=0):
    return engine(batch, generator=torch.Generator().manual_seed(seed))


def _trainer(root):
    cfg = _cfg(root, 1)
    loader, _, prepare, state = ttrain._setup(cfg, "cpu")
    encoder = make_frozen_encoder(_vqvae())
    batch = prepare(next(iter(loader)))
    return state, batch, encoder, DDPMParams.piecewise(cfg.denoiser.ddpm_train_steps)


def _profiled(fn):
    """``fn()`` under a new profiled session (a probe outside the profiler ends the last)."""
    assert not profiling.profiling_on()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof, profiling.snapshot()


def _counts(snap):
    return {n: v["count"] for n, v in snap["spans"].items()}


def _expected_engine_counts(n_iters, max_iters, merges):
    """The spans one engine call opens, from its ``n_iters``: the loop checks the exit
    before each iteration (and once more after an early exit), verifies after every
    iteration but the last allowed one, and fetches its results once."""
    verifies = min(n_iters, max_iters - 1)
    want = {"pfpp.engine.call": 1, "pfpp.engine.cache": n_iters,
            "pfpp.engine.step": n_iters * STEPS, "pfpp.engine.encode": n_iters * STEPS,
            "pfpp.engine.denoiser": n_iters * STEPS,
            "pfpp.sync.exit": n_iters + (n_iters < max_iters),
            "pfpp.sync.results": 1}
    if verifies:
        want.update({"pfpp.engine.verify": verifies, "pfpp.sync.merge_gate": verifies})
    if merges:
        want["pfpp.engine.merge"] = merges
    return want


def test_no_profiler_records_nothing(data):
    _profiled(profiling.profiling_on)  # an empty session
    _call(_engine(data, 2), _batch(data))
    state, batch, encoder, ddpm = _trainer(data)
    ttrain.train_step(state, batch, encoder, ddpm, torch.Generator().manual_seed(0))
    snap = profiling.snapshot()
    assert snap == {"spans": {}, "records": [], "dropped": 0}


def test_engine_outputs_bit_equal_under_profiler(data):
    engine, batch = _engine(data, 2), _batch(data)
    plain = _call(engine, batch)
    traced, _, snap = _profiled(lambda: _call(engine, batch))
    assert snap["spans"]
    assert plain.keys() == traced.keys()
    for k in plain:
        np.testing.assert_array_equal(traced[k], plain[k], err_msg=k)


@pytest.mark.parametrize("max_iters,forced", [(1, False), (3, False), (3, True)])
def test_engine_call_spans_and_syncs(data, max_iters, forced):
    engine = _engine(data, max_iters, threshold=0.0 if forced else 0.9)
    out, _, snap = _profiled(lambda: _call(engine, _batch(data, forced)))
    n_iters = int(out["n_iters"][0])
    merges = int(out["n_merged_pairs"].sum() > 0)
    assert bool(merges) == forced
    assert _counts(snap) == _expected_engine_counts(n_iters, max_iters, merges)
    if not forced:
        assert n_iters == max_iters  # no early exit: k exit checks and k - 1 merge gates
        assert _counts(snap)["pfpp.sync.exit"] == max_iters
    recs = {r["id"]: r for r in snap["records"]}
    call = next(r for r in recs.values() if r["name"] == "pfpp.engine.call")
    assert call["parent"] is None and {r["request"] for r in recs.values()} == {call["request"]}
    for step in (r for r in recs.values() if r["name"] == "pfpp.engine.step"):
        kids = sorted(r["name"] for r in recs.values() if r["parent"] == step["id"])
        assert kids == ["pfpp.engine.denoiser", "pfpp.engine.encode"]
        assert all(step["start"] <= recs[k]["start"] <= recs[k]["end"] <= step["end"]
                   for k in recs if recs[k]["parent"] == step["id"])
    spans = snap["spans"]
    for name, v in spans.items():
        assert 0.0 <= v["self_s"] <= v["total_s"], name
    kids = spans["pfpp.engine.encode"]["total_s"] + spans["pfpp.engine.denoiser"]["total_s"]
    step = spans["pfpp.engine.step"]
    assert step["self_s"] == pytest.approx(step["total_s"] - kids, abs=1e-9)


def test_engine_spans_in_the_chrome_trace(data, tmp_path):
    engine = _engine(data, 2)
    out, prof, snap = _profiled(lambda: _call(engine, _batch(data)))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    ranges = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "user_annotation" and \
                ev["name"].startswith("pfpp."):
            ranges[ev["name"]] = ranges.get(ev["name"], 0) + 1
    assert ranges == _counts(snap) == _expected_engine_counts(int(out["n_iters"][0]), 2, 0)


def test_two_engine_calls_are_two_requests(data):
    engine, batch = _engine(data, 1), _batch(data)
    _, _, snap = _profiled(lambda: [_call(engine, batch, s) for s in (0, 1)])
    calls = [r for r in snap["records"] if r["name"] == "pfpp.engine.call"]
    assert len(calls) == 2 and calls[0]["request"] != calls[1]["request"]
    for r in snap["records"]:
        owner = next(c for c in calls if c["start"] <= r["start"] <= r["end"] <= c["end"])
        assert r["request"] == owner["request"]


def test_train_step_spans(data):
    state, batch, encoder, ddpm = _trainer(data)
    gen = torch.Generator().manual_seed(0)
    _, _, snap = _profiled(lambda: [ttrain.train_step(state, batch, encoder, ddpm, gen)
                                    for _ in range(2)])
    # one process: all_reduce_gradients returns before its span
    assert _counts(snap) == {"pfpp.train.step": 2, "pfpp.train.encode": 2,
                             "pfpp.train.optimizer": 2}
    steps = {r["id"]: r for r in snap["records"] if r["name"] == "pfpp.train.step"}
    assert len({r["request"] for r in steps.values()}) == 2
    for r in snap["records"]:
        if r["name"] != "pfpp.train.step":
            assert steps[r["parent"]]["request"] == r["request"]


def test_prefetch_batches_build_and_wait(tmp_path):
    items = [{"x": np.full(3, i)} for i in range(5)]
    assert [b["x"][0] for b in prefetch_batches(iter(items))] == list(range(5))
    got, prof, snap = _profiled(lambda: [b["x"][0] for b in prefetch_batches(iter(items))])
    assert got == list(range(5))
    assert _counts(snap) == {"pfpp.loader.build": 5, "pfpp.loader.wait": 5}
    builds = [r for r in snap["records"] if r["name"] == "pfpp.loader.build"]
    assert all(r["parent"] is None and r["request"] is None for r in builds)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        names = [ev["name"] for ev in json.load(fh)["traceEvents"]
                 if ev.get("cat") == "user_annotation"]
    assert "pfpp.loader.build" not in names  # the producer thread ran no profiler
    assert names.count("pfpp.loader.wait") == 6  # the sentinel's wait is a range, not a span
    # with no profiler: nothing recorded, on either thread
    _profiled(profiling.profiling_on)
    assert list(prefetch_batches(iter(items))) == items
    assert profiling.snapshot()["spans"] == {}


def test_second_session_starts_afresh(data):
    engine, batch = _engine(data, 1), _batch(data)
    _, _, first = _profiled(lambda: _call(engine, batch))
    assert first["spans"]["pfpp.engine.call"]["count"] == 1
    _call(engine, batch)  # unprofiled: the probe finds none
    items = [{"x": np.zeros(2)}] * 3
    _, _, second = _profiled(lambda: list(prefetch_batches(iter(items))))
    assert _counts(second) == {"pfpp.loader.build": 3, "pfpp.loader.wait": 3}


def test_sync_values_and_record_bound(monkeypatch):
    t = torch.tensor([True, False])
    assert profiling.sync("pfpp.sync.exit", t.all()) is bool(t.all()) is False
    res = {"a": torch.arange(3), "b": torch.ones(2, 2)}
    got = profiling.sync("pfpp.sync.results", res)
    assert all(np.array_equal(got[k], res[k].numpy()) for k in res)
    monkeypatch.setattr(profiling, "MAX_RECORDS", 4)
    _, _, snap = _profiled(lambda: [profiling.sync("pfpp.sync.exit", t.any())
                                    for _ in range(7)])
    assert snap["spans"]["pfpp.sync.exit"]["count"] == 7
    assert len(snap["records"]) == 4 and snap["dropped"] == 3


def test_no_program_span_is_a_benchmark_span():
    from pfpp_bench.drivers import denoiser_train, engine

    for spans in (engine.SPANS, denoiser_train.SPANS):
        assert not [n for n in spans if n.startswith("pfpp.")]


# ----------------------------------------------------- the denoiser's CUDA-graph dispatch


def _denoiser(B=2, P=4, L=5, dim=16):
    """A small denoiser and one call's inputs, on the CPU."""
    torch.manual_seed(0)
    den = DenoiserTransformer(embed_dim=32, num_layers=2, num_heads=2, num_dim=dim,
                              max_parts=P, num_ada_embeds=1000)
    g = torch.Generator().manual_seed(1)
    valid = torch.ones(B, P)
    valid[0, -1] = 0
    ref = torch.zeros(B, P, dtype=torch.bool)
    ref[:, 0] = True
    args = (torch.randn((B, P, 7), generator=g), torch.randint(0, 1000, (B,), generator=g),
            torch.randn((B, P, L, dim), generator=g), torch.randn((B, P, L, 3), generator=g),
            valid, torch.rand((B, P, 1), generator=g) + 0.5, ref)
    return den, args


def _sorted_ptrs(den):
    return sorted(t.data_ptr() for t in itertools.chain(den.parameters(), den.buffers()))


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "grad", "train"])
def test_denoiser_runs_its_eager_body_on_the_cpu(mode):
    den, args = _denoiser()
    den.train(mode == "train")
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode}.get(
        mode, torch.enable_grad)
    with ctx():
        assert den._graph_key(args) is None
        torch.manual_seed(2)  # train mode's dropout draws the same masks in both calls
        out = den(*args)
        torch.manual_seed(2)
        ref = den._forward_eager(*args)
    assert torch.equal(out, ref)
    assert out.requires_grad == (mode in ("grad", "train"))
    assert den._graphs == {} and den._graph_params is None and den._graph_pool is None


@pytest.mark.parametrize("kind", ["plain", "forward_hook", "forward_pre_hook", "global_hook",
                                  "dtensor"])
def test_denoiser_graph_refused_by_hooks_and_dtensors(kind, tmp_path):
    den, args = _denoiser()
    den.eval()
    assert sorted(den._param_ptrs()) == _sorted_ptrs(den)
    if kind == "plain":
        return
    if kind == "dtensor":
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import Replicate, distribute_tensor

        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                                world_size=1)
        try:
            mesh = init_device_mesh("cpu", (1,))
            w = den.transformer_layers[1].ff.net[2].weight
            den.transformer_layers[1].ff.net[2].weight = nn.Parameter(
                distribute_tensor(w.detach(), mesh, [Replicate()]))
            assert den._param_ptrs() is None
        finally:
            dist.destroy_process_group()
        return
    target = den.transformer_layers[1].ff
    handle = {
        "forward_hook": lambda: target.register_forward_hook(lambda m, i, o: None),
        "forward_pre_hook": lambda: target.register_forward_pre_hook(lambda m, i: None),
        "global_hook": lambda: nn_module.register_module_forward_hook(lambda m, i, o: None),
    }[kind]()
    try:
        assert den._param_ptrs() is None
        with torch.no_grad():
            assert den._graph_key(args) is None
            assert torch.equal(den(*args), den._forward_eager(*args))
    finally:
        handle.remove()
    assert sorted(den._param_ptrs()) == _sorted_ptrs(den)


def test_denoiser_graph_key_follows_the_parameters():
    den, _ = _denoiser()
    den.eval()
    first = den._param_ptrs()
    with torch.no_grad():  # in place: a captured graph reads the new values
        den.param_fc.weight.mul_(2.0)
    den.load_state_dict(den.state_dict())
    assert den._param_ptrs() == first
    moved = []  # each of these moves or replaces a parameter: every graph is dropped
    den.load_state_dict({k: v.clone() for k, v in den.state_dict().items()}, assign=True)
    moved.append(den._param_ptrs())
    den.mlp_out_rot[4].weight = nn.Parameter(den.mlp_out_rot[4].weight.detach().clone())
    moved.append(den._param_ptrs())
    den.to(torch.float64)
    moved.append(den._param_ptrs())
    for before, after in zip([first] + moved, moved):
        assert after != before
    assert sorted(moved[-1]) == _sorted_ptrs(den)


def test_denoiser_train_mode_drops_its_graphs():
    den, _ = _denoiser()
    den.eval()
    held = object()
    den._graphs, den._graph_params, den._graph_pool = {"key": held}, (1, 2), (0, 1)
    den.eval()
    assert den._graphs == {"key": held}
    den.train()
    assert den._graphs == {} and den._graph_params is None and den._graph_pool is None


def test_no_denoiser_graph_span_on_the_cpu(data):
    engine = _engine(data, 2)
    _, _, snap = _profiled(lambda: _call(engine, _batch(data)))
    assert _counts(snap)["pfpp.engine.denoiser"] == 2 * STEPS
    assert not [n for n in snap["spans"] if n.startswith("pfpp.denoiser.")]
