"""Readings behind the matcher cell's correctness limits, on many seeds in one process.

``python -m pfpp_bench.readings_matcher --seeds 1,2,3 --control-seeds 4,5``

For each of ``--seeds`` it runs the cell's set-up and checked steps (a window of no seconds:
the rest of the first epoch) and prints the check's numbers: the lower readings. For each of
``--control-seeds`` it writes that seed's shapes and puts in the program's place the
reference in TF32 (the control) and the reference with its Sinkhorn at tau 0.1 (a planted
fault), each compared with the float32 reference as the check compares the program: the
upper readings. One JSON line a seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from pfpp_bench import manifest, seeds
from pfpp_bench.drivers import matcher_train as drv
from pfpp_bench.reference.numerics import Precision
from pfpp_bench.traffic import shapes

CELL = "matcher_train_b1"


def program_reading(w, cfg, seed, device, workers) -> dict:
    out = drv.run(w, cfg, seed, 0.0, False, device, workers, time.time())
    return {k: v for k, (v, _) in out["checks"].items()}


def control_reading(w, cfg, seed, device, workers) -> dict:
    tmp = tempfile.mkdtemp(prefix="pfpp_bench_")
    try:
        shapes.write_train_set(w["traffic"], seed, cfg["data"]["points_per_part"], tmp,
                               workers).get()
        steps_a_epoch = w["traffic"]["part_draw"]["shapes"] // cfg["train"]["batch_size"]
        args = (cfg, w, seed, tmp, seeds.derive(seed, drv.LOADER_SALT),
                cfg["train"]["epochs"] * steps_a_epoch, device)
        ref = drv.reference(*args)
        out = {}
        for name, kw in (("tf32", {"prec": Precision(tf32=True)}),
                         ("tau_0.1", {"model_override": {"sinkhorn_tau": 0.1}})):
            gaps = drv.compare(cfg, w, seed, drv.reference(*args, **kw), ref, device)
            out.update({f"{name}.{k}": v for k, (v, _) in gaps.items()})
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    bench = manifest.benchmark()
    w = manifest.workload(CELL)
    cfg = manifest.config(bench, manifest.cell(bench, CELL)["config"])
    device = torch.device(a.device)
    workers = min(8, os.cpu_count() or 1)
    for kind, seeds_, fn in (("program", a.seeds, program_reading),
                             ("control", a.control_seeds, control_reading)):
        for s in filter(None, seeds_.split(",")):
            out = fn(w, cfg, int(s), device, workers)
            print(json.dumps({"workload": CELL, "kind": kind, "seed": int(s), **out}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
