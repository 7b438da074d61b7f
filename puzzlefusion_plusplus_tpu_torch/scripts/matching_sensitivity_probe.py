"""The engine's sensitivity to the quality of its matching data (port of
``scripts/matching_sensitivity_probe.py``).

Matching data reaches the engine only through the verifier's edge-histogram features
(``inference/engine.py::edge_histograms``), so two matching trees can give the same engine
metrics when the verifier's thresholded decisions coincide everywhere, or when no merge
opens at all. This probe runs the held-out engine twice with ``inference.save_breakdown``,
on the matcher's written data (MATCH_DIR, as ``matcher_train_eval`` names it) and on the
GT-synthetic data, each under ``out_msens/<tag>``, and tabulates per shape the merged pairs,
the engine's iterations and part_acc under both; ``verdict`` reads the table.

``N_TRAIN=4096 SUBSET=-1 BATCH=8 MATCH_DIR=matching_data_matcher_out python -m
puzzlefusion_plusplus_tpu_torch.scripts.matching_sensitivity_probe [--cpu]`` on the run root
``<tmp>/pfpp_torch_gen_<N_TRAIN>`` (SUBSET=-1: every held-out shape); writes
``out_msens/matching_sensitivity.summary.json`` and collects it into
``chiprun_out/evidence/gen<N_TRAIN>/engine``.
"""

from __future__ import annotations

import json
import os
import sys

from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device, run_inference
from puzzlefusion_plusplus_tpu_torch.scripts import (
    Clock,
    cli_device,
    env_int,
    run_root,
    stage_dir,
)
from puzzlefusion_plusplus_tpu_torch.scripts.evidence import collect, write_summary
from puzzlefusion_plusplus_tpu_torch.scripts.synthetic_train_eval import gen_config
from puzzlefusion_plusplus_tpu_torch.utils.config import Config


def per_shape_table(model: dict, gt: dict) -> list[dict]:
    """The shapes both runs served, by ``data_id``: merged pairs, iterations and part_acc
    under the model's and the GT data (each a [model, gt] pair) and whether they differ."""
    table = []
    for i in sorted(set(model) & set(gt)):
        a, b = model[i], gt[i]
        table.append({
            "data_id": i,
            "merged_pairs": [a["n_merged_pairs"], b["n_merged_pairs"]],
            "n_iters": [a["n_iters"], b["n_iters"]],
            "part_acc": [a["part_acc"], b["part_acc"]],
            "differs": (a["n_merged_pairs"] != b["n_merged_pairs"]
                        or abs(a["part_acc"] - b["part_acc"]) > 1e-9),
        })
    return table


def verdict(table: list[dict]) -> dict:
    """The merges under each variant, the shapes that differ and what that says."""
    n_diff = sum(p["differs"] for p in table)
    total = [sum(p["merged_pairs"][j] for p in table) for j in (0, 1)]
    text = (
        "no merges executed under either variant — matching data cannot influence outcomes "
        "through a merge gate that never opens" if total == [0, 0] else
        f"merges executed ({total[0]} model / {total[1]} gt pairs) but "
        f"{n_diff}/{len(table)} shapes differ — "
        + ("decisions coincide despite differing features" if n_diff == 0
           else "outcomes ARE matching-sensitive"))
    return {"total_merged_pairs": {"model": total[0], "gt": total[1]},
            "shapes_differing": n_diff, "n_shapes": len(table), "verdict": text}


def run(cfg: Config, root: str, n_train: int = 4096, subset: int = -1, batch: int = 8,
        match_dir: str = "matching_data_matcher_out", device=None,
        evidence_dir: str | None = None) -> dict:
    """The probe on ``root`` at ``cfg``'s widths, from the run root's three stage
    checkpoints -> the summary it writes."""
    device = resolve_device(device)
    clock = Clock()
    out_dir = root + "/out_msens"
    cfg = gen_config(root, cfg)  # the encoder from the VQ-VAE stage's checkpoints
    cfg.denoiser.ckpt_path = stage_dir(cfg, "denoiser") + "/ckpt"
    cfg.verifier.ckpt_path = stage_dir(cfg, "verifier") + "/ckpt"
    cfg.data.overfit = subset
    cfg.trainer.output_dir = out_dir
    cfg.inference.batch_size = batch
    cfg.inference.save_trajectories = False
    cfg.inference.save_breakdown = True
    runs = {}
    for tag, path in (("model", root + "/" + match_dir), ("gt", root + "/matching_data")):
        cfg.data.matching_data_path = path
        cfg.trainer.experiment_name = tag
        bd_path = os.path.join(out_dir, tag, "inference", cfg.inference.inference_dir,
                               "breakdown.jsonl")
        if os.path.exists(bd_path):
            os.remove(bd_path)  # the records append
        agg = run_inference(cfg, device)
        bd = []
        if os.path.exists(bd_path):
            with open(bd_path) as fh:
                bd = [json.loads(line) for line in fh]
        runs[tag] = {"agg": agg, "by_shape": {b["data_id"]: b for b in bd}}
        clock.say(f"{tag}: {json.dumps(agg)} | merged_pairs="
                  f"{sum(b['n_merged_pairs'] for b in bd)}")
    table = per_shape_table(runs["model"]["by_shape"], runs["gt"]["by_shape"])
    summary = {"aggregate": {k: v["agg"] for k, v in runs.items()}, **verdict(table),
               "per_shape": table}
    clock.say(f"verdict: {summary['verdict']}")
    write_summary(out_dir, "matching_sensitivity", summary)
    collect(out_dir, f"gen{n_train}/engine", evidence_dir=evidence_dir)
    return summary


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = cli_device(argv)
    n_train = env_int("N_TRAIN", 4096)
    return run(Config(), run_root(f"gen_{n_train}"), n_train=n_train,
               subset=env_int("SUBSET", -1), batch=env_int("BATCH", 8),
               match_dir=os.environ.get("MATCH_DIR", "matching_data_matcher_out"),
               device=device)


if __name__ == "__main__":
    main()
