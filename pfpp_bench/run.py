"""One run of one benchmark cell.

``python -m pfpp_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``, from
the checkout's root. It finds the cell in ``BENCHMARK.json``, its parameters in
``pfpp_bench/workloads/<cell>.json``, its configuration's file and its driver
(``pfpp_bench/drivers/<driver>.py``), runs it on the card(s) the cell asks for, and prints:

* on standard output, a line of sample counts, then as the last line one JSON object with
  ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
  ``--trace 1`` its per-layer metrics, each read by ``pfpp_bench/metrics/<metric>.py``),
  ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
  correctness check compared, beside its limit;
* on standard error, as its last lines, the same numbers and limits.

It exits non-zero with no result where CUDA or the cards are missing, and where ``jax``,
``jaxlib``, ``flax`` or the JAX package are loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from pfpp_bench import harness, manifest


def merge(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             root: str = manifest.ROOT, cfg_override=None, w_override=None, t_start=None,
             workers: int | None = None) -> dict:
    """Run the cell and return its result (the last line's object)."""
    import torch

    t_start = harness.process_start() if t_start is None else t_start
    bench = manifest.benchmark(root)
    entry = manifest.cell(bench, name)
    w = merge(manifest.workload(name, root), w_override)
    cfg = merge(manifest.config(bench, entry["config"], root), cfg_override)
    device = torch.device(device or "cuda")
    workers = workers or min(32, os.cpu_count() or 1)
    out = manifest.driver(w["driver"]).run(w, cfg, seed, seconds, trace, device, workers,
                                           t_start, chips=entry["chips"])

    metrics = {}
    if trace:
        for m in manifest.per_layer(bench, name):
            value = manifest.reader(m["name"], root).read(out["readings"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in manifest.end_to_end(bench, name):
            metrics[m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
    checks = out["checks"]
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if trace and out["readings"].get("slice"):
        sl = out["readings"]["slice"]
        result["breakdown"] = {"device_ops": sl["device_ops"], "idle_gaps": sl["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    result["_counts"] = out["counts"]
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    t_start = harness.process_start()
    import torch

    bench = manifest.benchmark()
    chips = manifest.cell(bench, a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.say(f"needs {chips} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t_start=t_start)
    loaded = harness.forbidden_modules()
    if loaded:
        harness.say(f"forbidden modules loaded: {', '.join(loaded)}")
        return 4
    counts = result.pop("_counts")
    print("counts " + json.dumps(counts), flush=True)
    for k, c in result["checks"].items():
        harness.say(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
