"""Multi-seed re-scoring of the retained denoiser checkpoints, and the engine on the winner
(port of ``scripts/rescore_checkpoints.py``).

A single evaluation of 16-32 shapes swings by a few hundredths between adjacent
checkpoints, so a spike can win the top-k index. This re-scores every retained checkpoint
with the training loop's full-sampling evaluation (``make_sample_fn`` + ``eval_metrics`` on
the val-mode split), averaged over SEEDS seeds (1000 + s), rewrites ``topk.json``'s entries
with the means (the raw values stay under "raw", the re-score under "rescored"), and runs
the held-out engine again when the winner changes.

``N_TRAIN=4096 SEEDS=3 BATCH=16 RUN_ENGINE=1 BUCKET_MULT=4 python -m
puzzlefusion_plusplus_tpu_torch.scripts.rescore_checkpoints [--cpu]`` on the run root
``<tmp>/pfpp_torch_gen_<N_TRAIN>``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset
from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device, run_inference
from puzzlefusion_plusplus_tpu_torch.scripts import (
    Clock,
    cli_device,
    env_int,
    run_root,
    stage_dir,
)
from puzzlefusion_plusplus_tpu_torch.scripts.eval_train_split import (
    batch_metrics,
    make_sampler,
    val_loader,
)
from puzzlefusion_plusplus_tpu_torch.scripts.evidence import collect, write_summary
from puzzlefusion_plusplus_tpu_torch.scripts.synthetic_train_eval import gen_config
from puzzlefusion_plusplus_tpu_torch.training.state import STATE_FILE, best_checkpoint
from puzzlefusion_plusplus_tpu_torch.utils.config import Config


def run(cfg: Config, root: str, n_train: int = 4096, seeds: int = 3, batch: int = 16,
        run_engine: bool = True, bucket_mult: int = 4, device=None,
        evidence_dir: str | None = None) -> dict:
    """Re-score every checkpoint of ``root``'s denoiser -> the summary it writes."""
    device = resolve_device(device)
    clock = Clock()
    cfg = gen_config(root, cfg, bucket_mult)
    ckpt_dir = stage_dir(cfg, "denoiser") + "/ckpt"
    ds = DenoiserDataset(root + "/pc_data/val", mode="val", max_num_part=cfg.data.max_num_part,
                         multiple_ref_parts=cfg.denoiser.multiple_ref_parts)
    loader = val_loader(ds, batch, bucket_mult, cfg.data.max_num_part)
    prev_best = os.path.basename(best_checkpoint(ckpt_dir) or "")
    ckpts = sorted((d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                    and os.path.isfile(os.path.join(ckpt_dir, d, STATE_FILE))),
                   key=lambda d: int(d.split("_")[1]))
    clock.say(f"re-scoring {len(ckpts)} ckpts x {seeds} seeds (prev best: {prev_best or '-'})")

    scores = {}
    for name in ckpts:
        sample_fn = make_sampler(cfg, os.path.join(ckpt_dir, name), device)
        per_seed = []
        for s in range(seeds):
            gen = torch.Generator(device=device).manual_seed(1000 + s)
            accs = batch_metrics(sample_fn, loader, bucket_mult, cfg.data.max_num_part, gen,
                                 device)
            per_seed.append({k: float(np.mean([a[k] for a in accs])) for k in accs[0]})
        scores[name] = {
            "part_acc_mean": float(np.mean([p["part_acc"] for p in per_seed])),
            "part_acc_std": float(np.std([p["part_acc"] for p in per_seed])),
            "part_acc_nonref_mean": float(np.mean([p["part_acc_nonref"] for p in per_seed])),
            "per_seed": per_seed,
        }
        clock.say(f"{name}: part_acc {scores[name]['part_acc_mean']:.4f} "
                  f"+-{scores[name]['part_acc_std']:.4f} "
                  f"nonref {scores[name]['part_acc_nonref_mean']:.4f}")
    winner = max(scores, key=lambda n: scores[n]["part_acc_mean"])
    clock.say(f"winner: {winner} ({scores[winner]['part_acc_mean']:.4f})")

    # the index ranks on the seed means from now on; the raw single evaluations stay
    idx_path = os.path.join(ckpt_dir, "topk.json")
    with open(idx_path) as f:
        idx = json.load(f)
    idx["entries"] = {n: scores[n]["part_acc_mean"] for n in scores}
    idx["rescored"] = {"seeds": seeds, "n_val": len(ds)}
    with open(idx_path, "w") as f:
        json.dump(idx, f)

    eng_dir = cfg.trainer.output_dir + "/engine_eval"
    os.makedirs(eng_dir, exist_ok=True)
    summary = {"scores": {n: {k: v for k, v in s.items() if k != "per_seed"}
                          for n, s in scores.items()},
               "winner": winner, "prev_best": prev_best, "seeds": seeds}
    if run_engine and prev_best != winner:
        cfg.denoiser.ckpt_path = os.path.join(ckpt_dir, winner)
        cfg.verifier.ckpt_path = stage_dir(cfg, "verifier") + "/ckpt"
        cfg.trainer.experiment_name = "everyday_rescored"
        cfg.inference.batch_size = 8
        cfg.inference.save_trajectories = False
        cfg.inference.save_breakdown = True
        agg = run_inference(cfg, device)
        clock.say(f"HELD-OUT engine (rescored best {winner}): {json.dumps(agg)}")
        summary["heldout_engine_rescored_best"] = agg
    write_summary(eng_dir, "ckpt_rescore", summary)
    collect(eng_dir, f"gen{n_train}/engine", evidence_dir=evidence_dir)
    clock.say("done")
    return summary


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = cli_device(argv)
    n_train = env_int("N_TRAIN", 4096)
    return run(Config(), run_root(f"gen_{n_train}"), n_train=n_train,
               seeds=env_int("SEEDS", 3), batch=env_int("BATCH", 16),
               run_engine=bool(env_int("RUN_ENGINE", 1)),
               bucket_mult=env_int("BUCKET_MULT", 4), device=device)


if __name__ == "__main__":
    main()
