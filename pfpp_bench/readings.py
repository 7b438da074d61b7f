"""Readings behind the correctness limits of a cell, on many seeds in one process.

``python -m pfpp_bench.readings --workload engine_b8 --seeds 1,2,3 --control-seeds 4,5,6``

Serving cells: for each of ``--seeds`` it runs the program's engine on the calls a run would
check (the cell's ``check.calls``, the largest part pad among them) and follows them through
the reference, one step at a time and run free (``free_pose_gap``, the check's path where
the program does not show its steps): the lower readings. For each of ``--control-seeds``
it runs the reference itself in TF32 in the program's place, on the same calls, and follows
those both ways: the control's readings, the upper ones.

Training cells: the program's checked steps against the reference, as a run's set-up makes
them; and in the program's place the reference in TF32 (the control) and the reference with
half of each batch left out (a planted fault). One JSON line a seed; the benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from pfpp_bench import harness, manifest, seeds
from pfpp_bench.drivers import engine as drv
from pfpp_bench.reference import engine as ref_engine
from pfpp_bench.reference.numerics import Precision


def serving_calls(w: dict, batches: list) -> list[int]:
    """The calls a reading checks: one pass over the batches, at most ``check.calls``, the
    largest pad first."""
    n = len(batches)
    by_pad = sorted(range(n), key=lambda k: -batches[k]["part_valids"].shape[1])
    return by_pad[:max(w["check"]["calls"], 1)]


def both_ways(cfg, w, seed, batches, records, device) -> dict:
    """The check's numbers one step at a time, and those of the free runs: the largest pose
    gap over the first ``check.free_steps`` steps (``free_pose_gap``) and over each block
    of 5 steps (``free_by_5``), and their mismatches."""
    from pfpp_bench.reference.numerics import FP32

    out = {k: v for k, (v, _) in drv.check(cfg, w, seed, batches, records, device).items()}
    params = harness.draw_weights(cfg, seed, device)
    rcfg = {**cfg, "engine": {**cfg["engine"], **w["check"]["engine"]}}
    free, blocks, mismatch = 0.0, [], 0
    for j, record in sorted(records.items()):
        b = drv._tensors(batches[j % len(batches)], device)
        noise = drv.call_noise(seed, j, *b["part_valids"].shape, cfg, device)
        ref = ref_engine.follow(params, rcfg, b, noise, None, FP32)
        g = ref_engine.free_gaps(ref, record, b, w["check"]["free_steps"])
        free, mismatch = max(free, g["pose"]), mismatch + g["mismatch"]
        by5 = ref_engine.free_gaps(ref, record, b, 5)["by_block"]
        blocks = [max(x) for x in itertools.zip_longest(blocks, by5, fillvalue=0.0)]
    out.update(free_pose_gap=free, free_by_5=blocks, free_mismatches=mismatch)
    return out


def program_reading(w, cfg, seed, device, workers) -> dict:
    sv = drv.Serving(w, cfg, seed, device, workers)
    idx = serving_calls(w, sv.batches)
    for i in idx:
        sv.call(i)
    records = sv.records(range(len(idx)))
    batches = sv.batches
    sv.close()
    return both_ways(cfg, w, seed, batches, records, device)


def control_reading(w, cfg, seed, device, workers) -> dict:
    from pfpp_bench.traffic import shapes

    recs = shapes.make_shapes(w["traffic"], seed, cfg["data"]["points_per_part"], workers)
    batches = shapes.engine_batches(w["traffic"], recs.get(), seed, cfg["data"]["max_num_part"])
    params = harness.draw_weights(cfg, seed, device)
    rcfg = {**cfg, "engine": {**cfg["engine"], **w["check"]["engine"]}}
    records = {}
    for i in serving_calls(w, batches):
        b = batches[i]
        noise = drv.call_noise(seed, i, *b["part_valids"].shape, cfg, device)
        records[i] = ref_engine.follow(params, rcfg, drv._tensors(b, device), noise, None,
                                       Precision(tf32=True))
    return both_ways(cfg, w, seed, batches, records, device)


def train_program_reading(w, cfg, seed, device, workers) -> dict:
    from pfpp_bench.drivers import denoiser_train

    out = denoiser_train.run(w, cfg, seed, 0.0, False, device, workers, time.time())
    return {k: v for k, (v, _) in out["checks"].items()}


def train_control_reading(w, cfg, seed, device, workers) -> dict:
    """The reference in TF32 and the reference with half of each batch left out, each in
    the program's place."""
    from pfpp_bench.drivers import denoiser_train as drv_t
    from pfpp_bench.traffic import shapes

    tmp = tempfile.mkdtemp(prefix="pfpp_bench_")
    try:
        shapes.write_train_set(w["traffic"], seed, cfg["data"]["points_per_part"], tmp,
                               workers).get()
        loader_seed = seeds.derive(seed, drv_t.LOADER_SALT)
        args = (cfg, w, seed, tmp, loader_seed, 1, device)
        ref = drv_t.reference(*args)
        out = {}
        for name, kw in (("tf32", {"prec": Precision(tf32=True)}), ("half_batch", {"half": True})):
            gaps = drv_t.compare(cfg, w, seed, drv_t.reference(*args, **kw), ref, device)
            out.update({f"{name}.{k}": v for k, (v, _) in gaps.items()})
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    bench = manifest.benchmark()
    entry = manifest.cell(bench, a.workload)
    w = manifest.workload(a.workload)
    cfg = manifest.config(bench, entry["config"])
    device = torch.device(a.device)
    workers = min(8, os.cpu_count() or 1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    serving = w["driver"] == "engine"
    for kind, seeds_, fn in (
            ("program", a.seeds, program_reading if serving else train_program_reading),
            ("control", a.control_seeds, control_reading if serving else train_control_reading)):
        for s in filter(None, seeds_.split(",")):
            out = fn(w, cfg, int(s), device, workers)
            print(json.dumps({"workload": a.workload, "kind": kind, "seed": int(s), **out}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
