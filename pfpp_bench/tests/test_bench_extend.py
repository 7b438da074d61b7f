"""A cell, a configuration and a per-layer metric are added by new files and new
``BENCHMARK.json`` entries alone: the harness finds them by name."""

from __future__ import annotations

import json
import shutil

from pfpp_bench import manifest, run


def copy_tree(tmp_path):
    shutil.copytree(f"{manifest.ROOT}/pfpp_bench", tmp_path / "pfpp_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(f"{manifest.ROOT}/BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_new_cell_config_and_metric_need_no_edit(tmp_path, tiny):
    root = copy_tree(tmp_path)
    before = {p: p.read_bytes() for p in (root / "pfpp_bench").rglob("*") if p.is_file()}
    bench = json.loads((root / "BENCHMARK.json").read_text())

    cfg = json.loads((root / "pfpp_bench/configs/pfpp_everyday_infer.json").read_text())
    cfg["name"] = "pfpp_small_infer"
    (root / "pfpp_bench/configs/pfpp_small_infer.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "pfpp_small_infer", "source": "https://example.org/x",
                             "file": "pfpp_bench/configs/pfpp_small_infer.json",
                             "reduced": [], "why": "a test"})
    w = json.loads((root / "pfpp_bench/workloads/engine_b8.json").read_text())
    w["traffic"]["batch"] = 4
    (root / "pfpp_bench/workloads/engine_b4.json").write_text(json.dumps(w))
    bench["workloads"].append({"name": "engine_b4", "config": "pfpp_small_infer",
                               "traffic": "sorted_b4", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("engine_b4")
    (root / "pfpp_bench/metrics/calls_in_slice.serve.py").write_text(
        "def read(r):\n    return r.get('slice_calls')\n")
    bench["per_layer"].append({"name": "calls_in_slice.serve", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "assemblies_per_s",
                               "workloads": ["engine_b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = manifest.benchmark(str(root))
    assert [m["name"] for m in manifest.per_layer(after, "engine_b4")] == ["calls_in_slice.serve"]
    assert manifest.reader("calls_in_slice.serve", str(root)).read({"slice_calls": 3}) == 3
    over, w_over = tiny["serve"]
    out = run.run_cell("engine_b4", 5, 0.2, False, device="cpu", root=str(root),
                       cfg_override=over, w_override=w_over, workers=1)
    assert out["correct"] and set(out["metrics"]) == {"assemblies_per_s", "setup_s"}
    for p, data in before.items():  # nothing that was there changed
        assert p.read_bytes() == data, p
