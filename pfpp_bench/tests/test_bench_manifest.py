"""BENCHMARK.json against the benchmark's contract, and the files it names."""

from __future__ import annotations

import json
import os
import re

from pfpp_bench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return manifest.benchmark()


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["pfpp_bench"] and len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    assert cells <= 24
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_text():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for x in b["configs"] + b["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for m in b["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_entries_have_just_their_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_cells_report_what_they_must():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for w in b["workloads"]:
        mine = {m["name"] for m in manifest.end_to_end(b, w["name"])}
        assert "setup_s" in mine and len(mine) >= 2
        assert manifest.per_layer(b, w["name"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in manifest.end_to_end(b, cell)}


def test_at_most_one_four_chip_cell_in_four():
    b = bench()
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in b["workloads"])
    assert len(four) <= max(1, len(b["workloads"]) // 4)


def test_every_named_file_exists():
    b = bench()
    for c in b["configs"]:
        assert c["file"].startswith("pfpp_bench/")
        with open(os.path.join(manifest.ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["precision"] == "fp32" and "assumed" in cfg
    for w in b["workloads"]:
        spec = manifest.workload(w["name"])
        assert manifest.driver(spec["driver"]).run
        assert w["config"] in {c["name"] for c in b["configs"]}
        assert {"limits"} <= set(spec["check"])
    for m in b["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)


def test_readers_return_none_without_readings():
    for m in bench()["per_layer"]:
        assert manifest.reader(m["name"]).read({}) is None
