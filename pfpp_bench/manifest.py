"""``BENCHMARK.json`` and the files it names: each cell's workload file, each configuration's
file, each per-layer metric's reader and each driver, found by name."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(bench: dict, name: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def workload(name: str, root: str = ROOT) -> dict:
    with open(os.path.join(root, "pfpp_bench", "workloads", f"{name}.json")) as fh:
        return json.load(fh)


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as fh:
                return json.load(fh)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics this cell reports: those listing it, and those without a list
    that move one of its end-to-end metrics."""
    moves = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moves)]


def reader(metric: str, root: str = ROOT):
    """The reader module of a per-layer metric: ``pfpp_bench/metrics/<metric>.py``."""
    path = os.path.join(root, "pfpp_bench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"pfpp_bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return importlib.import_module(f"pfpp_bench.drivers.{name}")
