"""Failure-analysis tables over an engine's ``breakdown.jsonl`` (port of
``scripts/engine_breakdown.py``): accuracy by part-count bucket and by non-reference
part-size quartile, reference against non-reference parts.

The records are those ``inference/run.py::save_breakdown_records`` writes
(``inference.save_breakdown=true``). The reference's evaluator exposes only batch means
(evaluator.py:84-117); these tables answer what an at-scale number raises next: are small
fragments the failures, does accuracy fall with the part count, how much of part_acc is the
pinned reference parts.

``python -m puzzlefusion_plusplus_tpu_torch.scripts.engine_breakdown
<out_dir_or_breakdown.jsonl> [evidence_tag]`` (host only).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from puzzlefusion_plusplus_tpu_torch.scripts.evidence import EVIDENCE_DIR, write_summary


def load_records(path: str) -> list[dict]:
    if os.path.isdir(path):
        path = os.path.join(path, "breakdown.jsonl")
    out = []
    with open(path) as fh:
        for line in fh:
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # a torn tail line
    return out


def analyze(records: list[dict]) -> dict:
    """-> accuracy over all parts and over the non-reference parts, sliced by part-count
    bucket and by non-reference part-size quartile."""
    acc, ref, scale, nparts = [], [], [], []
    for r in records:
        acc.extend(r["acc_per_part"])
        ref.extend(r["ref_part"])
        scale.extend(r["part_scale"])
        nparts.extend([r["num_parts"]] * r["num_parts"])
    acc = np.asarray(acc, bool)
    ref = np.asarray(ref, bool)
    scale = np.asarray(scale, np.float64)
    nparts = np.asarray(nparts, np.int64)
    nonref = ~ref

    def rate(mask):
        return round(float(acc[mask].mean()), 4) if mask.any() else None

    by_count = {}
    for lo, hi in ((2, 4), (5, 8), (9, 12), (13, 20)):
        m = (nparts >= lo) & (nparts <= hi)
        by_count[f"{lo}-{hi}"] = {"n_parts": int(m.sum()), "acc_all": rate(m),
                                  "acc_nonref": rate(m & nonref)}

    by_size = {}
    if nonref.any():
        edges = [-np.inf, *np.quantile(scale[nonref], [0.25, 0.5, 0.75]), np.inf]
        for qi in range(4):
            m = nonref & (scale > edges[qi]) & (scale <= edges[qi + 1])
            by_size[f"q{qi + 1}"] = {
                "n_parts": int(m.sum()),
                "scale_range": [round(float(max(edges[qi], scale[nonref].min())), 5),
                                round(float(min(edges[qi + 1], scale[nonref].max())), 5)],
                "acc_nonref": rate(m),
            }

    return {
        "n_shapes": len(records),
        "n_parts_total": int(acc.size),
        "ref_fraction": round(float(ref.mean()), 4),
        "acc_all_parts": rate(np.ones_like(acc, bool)),
        "acc_ref_parts": rate(ref),  # about 1.0 by construction (pinned to the GT)
        "acc_nonref_parts": rate(nonref),
        "by_part_count": by_count,
        "by_nonref_part_scale_quartile": by_size,
    }


def summarize(path: str, tag: str | None = None, evidence_dir: str | None = None) -> dict:
    """``analyze`` the records under ``path``, print them, and with ``tag`` write them as
    ``<evidence_dir>/<tag>/engine_breakdown.summary.json``."""
    result = analyze(load_records(path))
    print(json.dumps(result, indent=1))
    if tag:
        ev_dir = os.path.join(evidence_dir or EVIDENCE_DIR, tag)
        os.makedirs(ev_dir, exist_ok=True)
        write_summary(ev_dir, "engine_breakdown", result)
    return result


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    return summarize(argv[0] if argv else "output/everyday/inference/results",
                     argv[1] if len(argv) > 1 else None)


if __name__ == "__main__":
    main()
