"""Evidence capture and plateau detection (port of ``scripts/evidence.py``).

* ``loss_plateaued`` — data-driven stopping: the median of the last ``window`` logged values
  against the previous window's; a stage keeps extending its budget (in bounded chunks, see
  ``synthetic_train_eval``) until the improvement drops below ``min_rel_improve``.
* ``collect`` — copy every stage's ``metrics.jsonl``, ``*.summary.json`` and ``topk.json``
  into ``<evidence_dir>/<tag>/`` (each path flattened into the file name) the moment a stage
  ends, with a manifest line of source path, mtime and line count. The default evidence
  directory is the port's ``chiprun_out/evidence/`` (git-ignored: a remote run's outputs
  come back there); the repository's ``evidence/`` tree is the JAX package's.

``python -m puzzlefusion_plusplus_tpu_torch.scripts.evidence [RUN_ROOT] [TAG]`` collects one
run root (host only).
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import sys
import time

from puzzlefusion_plusplus_tpu_torch.scripts import run_root

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EVIDENCE_DIR = os.path.join(REPO, "chiprun_out", "evidence")


def read_metric(metrics_path: str, key: str) -> list[tuple[int, float]]:
    """(step, value) series of one key of a ``MetricsLogger`` JSONL file."""
    out = []
    if not os.path.exists(metrics_path):
        return out
    with open(metrics_path) as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # a torn tail line of a killed run
            if key in rec:
                out.append((int(rec.get("step", len(out))), float(rec[key])))
    return out


def loss_plateaued(metrics_path: str, key: str, window: int = 8,
                   min_rel_improve: float = 0.02, mode: str = "min") -> tuple[bool, dict]:
    """True when ``key`` stopped improving: the median of the last ``window`` samples
    improved on the previous window's median by less than ``min_rel_improve`` (relative).
    ``mode`` is 'min' for losses, 'max' for metrics like part_acc. With fewer than
    2 * window samples the series counts as still moving (False)."""
    series = [v for _, v in read_metric(metrics_path, key)]
    info = {"key": key, "n": len(series), "window": window}
    if len(series) < 2 * window:
        return False, info
    prev = statistics.median(series[-2 * window:-window])
    last = statistics.median(series[-window:])
    improve = (prev - last) if mode == "min" else (last - prev)
    denom = max(abs(prev), 1e-12)
    info.update(prev_median=prev, last_median=last, rel_improve=improve / denom)
    return improve / denom < min_rel_improve, info


def collect(run_root: str, tag: str, extra: dict | None = None,
            evidence_dir: str | None = None) -> str:
    """Copy every ``metrics.jsonl`` / ``*.summary.json`` / ``topk.json`` under ``run_root``
    into ``<evidence_dir>/<tag>/`` (``EVIDENCE_DIR`` by default), append a manifest line and
    return the destination. Collecting again overwrites the files with the newer ones."""
    dst_dir = os.path.join(evidence_dir or EVIDENCE_DIR, tag)
    os.makedirs(dst_dir, exist_ok=True)
    copied = []
    for root, _dirs, files in os.walk(run_root):
        for f in files:
            if f == "metrics.jsonl" or f.endswith(".summary.json") or f == "topk.json":
                src = os.path.join(root, f)
                dst = os.path.join(dst_dir, os.path.relpath(src, run_root).replace(os.sep, "__"))
                shutil.copy2(src, dst)
                with open(src) as fh:
                    n_lines = sum(1 for _ in fh)
                copied.append({"src": src, "dst": os.path.relpath(dst, REPO),
                               "mtime": os.path.getmtime(src), "lines": n_lines})
    with open(os.path.join(dst_dir, "MANIFEST.jsonl"), "a") as fh:
        fh.write(json.dumps({"collected_at": time.time(), "run_root": run_root,
                             "files": copied, "extra": extra or {}}) + "\n")
    return dst_dir


def write_summary(run_root: str, name: str, payload: dict) -> str:
    """Write ``<run_root>/<name>.summary.json`` (which ``collect`` picks up)."""
    path = os.path.join(run_root, f"{name}.summary.json")
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=1, default=float)
    return path


def main(argv=None) -> str:
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0] if argv else run_root("gen_256")
    tag = argv[1] if len(argv) > 1 else os.path.basename(root.rstrip("/"))
    dst = collect(root, tag)
    print("collected ->", dst)
    return dst


if __name__ == "__main__":
    main()
