"""The matcher cell (``matcher_train_b1``) and the ``engine_b1`` cell on the CPU: the
configuration builds the program's matcher at its widths, the manifest finds both cells and
their metrics, the FLOP and byte counts, the readers on a program without the matcher's
spans, the imports, and a tiny run of the cell end to end, sound and with a planted fault."""

from __future__ import annotations

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from pfpp_bench import flops_matcher, harness, manifest, run
from pfpp_bench.drivers import matcher_train as drv
from pfpp_bench.reference import matcher as R
from pfpp_bench.reference import matcher_params as MP
from pfpp_bench.tests.test_bench_imports import imported
from pfpp_bench.traffic import shapes

CELL, CONFIG = "matcher_train_b1", "jigsaw_everyday_matcher_train"
MATCH_METRICS = {"mfu_pct.match", "matcher_encoder_ms_per_step.match",
                 "matcher_attention_ms_per_step.match", "sinkhorn_ms_per_step.match",
                 "sinkhorn_roofline_pct.match", "host_ms_per_step.match",
                 "host_syncs_per_step.match"}
# the accepted metrics that read the matcher cell too: no span of the matcher's needed
SHARED_TRAIN = {"device_idle_pct.train", "batch_build_ms.train",
                "loader_wait_ms_per_step.train"}
SERVE = {"device_idle_pct.serve", "mfu_pct.serve", "encoder_ms_per_step.serve",
         "encoder_roofline_pct.serve", "denoiser_ms_per_step.serve", "verify_ms_per_iter.serve",
         "host_ms_per_step.serve", "sync_wait_ms_per_call.serve", "host_syncs_per_call.serve",
         "denoiser_graph_replay_pct.serve"}
TINY = {"model": {"pc_feat_dim": 32, "aff_feat_dim": 16, "sa_npoints": [64, 32, 16, 8]},
        "data": {"num_points": 256, "max_num_part": 5, "points_per_part": 128}}
TINY_W = {"traffic": {"part_draw": {"low": 2, "high": 5, "shapes": 6}}}


def config() -> dict:
    b = manifest.benchmark()
    return manifest.config(b, manifest.cell(b, CELL)["config"])


def tiny_config() -> dict:
    return run.merge(config(), TINY)


def test_configuration_is_the_published_recipe():
    cfg = config()
    m, d, t = cfg["model"], cfg["data"], cfg["train"]
    assert (m["pc_feat_dim"], m["aff_feat_dim"], m["tf_num_heads"], m["tf_num_samples"]) == (
        128, 512, 8, 16)
    assert m["sa_npoints"] == [1024, 256, 64, 16]
    assert (m["sinkhorn_iters"], m["sinkhorn_tau"], m["cls_method"]) == (20, 0.05, "binary")
    assert (d["num_points"], d["max_num_part"], d["fracture_label_threshold"]) == (5000, 20,
                                                                                    0.025)
    assert (t["batch_size"], t["epochs"], t["lr"], t["mat_epoch"], t["rig_epoch"]) == (
        1, 250, 1e-3, 10, 200)
    assert cfg["precision"] == "fp32" and cfg["tf32"] is False
    entry = next(c for c in manifest.benchmark()["configs"] if c["name"] == CONFIG)
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]


def test_set_up_builds_the_programs_matcher_at_the_files_widths():
    """Every tensor of the spec loads into the program's model, shape for shape, and the
    model holds nothing else (``harness.program_config`` knows only the PuzzleFusion++
    models)."""
    cfg = config()
    model = drv.program_model(cfg, torch.device("cpu"))
    weights = MP.draw(cfg["model"], 123, torch.device("cpu"))
    harness.load(model, weights)
    state = model.state_dict()
    for k, v in weights.items():
        assert state[k].shape == v.shape, k
    assert {k for k in state if not k.endswith("num_batches_tracked")} == set(weights)
    assert model.encoder.sa1.npoint == 1024 and model.sinkhorn_iters == 20


def test_manifest_finds_both_cells_and_their_metrics():
    b = manifest.benchmark()
    for cell, e2e, driver in ((CELL, "train_shapes_per_s", "matcher_train"),
                              ("engine_b1", "assemblies_per_s", "engine")):
        entry = manifest.cell(b, cell)
        assert entry["chips"] == 1
        assert manifest.workload(cell)["driver"] == driver
        assert manifest.driver(driver).run
        assert {m["name"] for m in manifest.end_to_end(b, cell)} == {e2e, "setup_s"}
    assert {m["name"] for m in manifest.per_layer(b, CELL)} == MATCH_METRICS | SHARED_TRAIN
    # engine_b1 reads what engine_b8 reads: the same driver, one shape a call
    assert {m["name"] for m in manifest.per_layer(b, "engine_b1")} == SERVE == {
        m["name"] for m in manifest.per_layer(b, "engine_b8")}
    for name in MATCH_METRICS:
        assert callable(manifest.reader(name).read)


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("flops") / "train")
    shapes.write_train_set({"part_draw": {"low": 2, "high": 5, "shapes": 2}}, 5, 128, d, 1).get()
    cfg = tiny_config()
    cfg["train"]["batch_size"] = 2
    return cfg, R.MatcherData(d, cfg["data"]).batches(3, 2, 1)[0]


def test_flops_match_the_counter_on_the_reference(batch):
    cfg, b = batch
    p = {k: v.requires_grad_(True) for k, v in MP.draw(cfg["model"], 1, "cpu").items()
         if "running" not in k}
    with FlopCounterMode(display=False) as fc:
        out = R.forward(p, cfg, {k: torch.as_tensor(v) for k, v in b.items()})
        out["loss"].backward()
    n_crit = out["n_crit"].tolist()
    assert flops_matcher.train_step_flops(cfg, n_crit, computed=True) == fc.get_total_flops()
    # the needed count takes the GT permutation's distances over the critical points only
    N = cfg["data"]["num_points"]
    gap = sum(2 * 3 * (N * N - n * n) for n in n_crit)
    assert flops_matcher.train_step_flops(cfg, n_crit) == fc.get_total_flops() - gap


def test_sinkhorn_bytes_at_a_known_shape():
    # 20 iterations over a 1000 x 1000 block: 40 half-iterations' reads, the scores read
    # and the result written, 4 bytes each
    assert flops_matcher.sinkhorn_bytes(1000, 20) == 42 * 1000 * 1000 * 4
    assert flops_matcher.sinkhorn_bytes(0, 20) == 0


def slice_without_spans() -> dict:
    """A traced run's readings from a program without the matcher's spans."""
    return {"slice": {"wall_s": 1.0, "busy_s": 0.5,
                      "span_device_s": dict.fromkeys(drv.SPANS, 0.0),
                      "span_count": dict.fromkeys(drv.SPANS, 0),
                      "device_ops": [], "idle_gaps": []},
            "slice_steps": 8, "spans": {"pfpp.loader.wait": {"count": 8, "total_s": 0.1,
                                                            "self_s": 0.1}},
            "match_flops": 1e12, "sinkhorn_bytes": 1e9, "window_s": 10.0}


@pytest.mark.parametrize("metric", sorted(MATCH_METRICS))
def test_readers_return_none_without_the_matcher_spans(metric):
    assert manifest.reader(metric).read(slice_without_spans()) is None


@pytest.mark.parametrize("metric", sorted(MATCH_METRICS))
def test_readers_read_the_matcher_spans(metric):
    r = slice_without_spans()
    sl = r["slice"]
    sl["span_count"].update({n: 8 for n in drv.SPANS})
    sl["span_device_s"].update({n: 0.01 for n in drv.SPANS})
    r["spans"].update({"pfpp.match.step": {"count": 8, "total_s": 0.8, "self_s": 0.1},
                       "pfpp.sync.match_batch": {"count": 8, "total_s": 0.01, "self_s": 0.01}})
    value = manifest.reader(metric).read(r)
    assert value is not None and value > 0
    expected = {"matcher_encoder_ms_per_step.match": 1.25,
                "host_ms_per_step.match": 100.0, "host_syncs_per_step.match": 1.0,
                "sinkhorn_roofline_pct.match": 100.0 * 1e9 / 3.35e12 / 0.01}
    if metric in expected:
        assert value == pytest.approx(expected[metric])


@pytest.mark.parametrize("metric", sorted(SHARED_TRAIN))
def test_shared_training_readers_read_the_matcher_cell_without_its_spans(metric, monkeypatch):
    """The idle share, the loader's wait and the batch build read a program without the
    matcher's spans: the device trace, the driver's clock and the loader's span."""
    from puzzlefusion_plusplus_tpu_torch.utils import profiling

    r = slice_without_spans()
    r["host"] = {"loader_wait": [0.002, 0.004]}
    monkeypatch.setattr(profiling, "snapshot", lambda: {"spans": {
        "pfpp.loader.build": {"count": 4, "total_s": 0.02, "self_s": 0.02}}})
    expected = {"device_idle_pct.train": 50.0, "loader_wait_ms_per_step.train": 3.0,
                "batch_build_ms.train": 5.0}
    assert manifest.reader(metric).read(r) == pytest.approx(expected[metric])


def test_new_modules_import_no_jax_and_the_reference_nothing_of_the_program():
    here = os.path.join(manifest.ROOT, "pfpp_bench")
    new = ["flops_matcher.py", "readings_matcher.py", "drivers/matcher_train.py",
           "reference/matcher.py", "reference/matcher_params.py"]
    new += [f"metrics/{m}.py" for m in MATCH_METRICS]
    for rel in new:
        mods = imported(os.path.join(here, rel))
        assert not mods & set(harness.FORBIDDEN), rel
        if rel.startswith("reference/"):
            assert "puzzlefusion_plusplus_tpu_torch" not in mods, rel


def tiny_run():
    return run.run_cell(CELL, 2147483747, 0.5, False, device="cpu", cfg_override=TINY,
                        w_override=TINY_W, workers=1)


def test_tiny_run_checks_each_number():
    out = tiny_run()
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "update_gap", "ds_gap"}
    assert set(out["metrics"]) == {"train_shapes_per_s", "setup_s"}
    for name in ("loss_gap", "grad_gap", "ds_gap"):
        assert out["checks"][name]["value"] <= out["checks"][name]["limit"], name
    assert (out["attempted"] + 3) % 6 == 0  # whole epochs of the 6 shapes, the 3 checked first


def test_a_planted_fault_fails_the_check(monkeypatch):
    """The program's Sinkhorn at 19 iterations."""
    from puzzlefusion_plusplus_tpu_torch.matching import model

    inner = model.sinkhorn_log

    def short(scores, n_rows, n_cols, max_iter=20, tau=0.05):
        return inner(scores, n_rows, n_cols, max_iter - 1, tau)

    monkeypatch.setattr(model, "sinkhorn_log", short)
    out = tiny_run()
    assert not out["correct"]
    assert out["checks"]["ds_gap"]["value"] > out["checks"]["ds_gap"]["limit"]
