"""The matcher trained on the generalization run's shapes, then its matching data through the
engine (port of ``scripts/matcher_train_eval.py``).

1. The shapes of ``synthetic_train_eval``'s run root (``<tmp>/pfpp_torch_gen_<N_TRAIN>``,
   made here if that run has not made them): N_TRAIN training and N_VAL held-out shapes.
2. The metric's ceiling on the first ``min(N_VAL, 16)`` held-out shapes
   (``matching/oracle.py::oracle_matching_stats``): the held-out ``mat_f1`` curve reads
   as achieved over oracle. Written as ``oracle_ceiling.summary.json`` after training.
3. The production matcher (``matching.train.make_model`` at its default widths, seeded as
   ``train_matching`` seeds its default model) trained through ``train_matching`` with the
   held-out ``mat_f1`` monitor every VAL_EVERY epochs and POS_WEIGHT on the classifier's
   positives (above 1 the classifier leaves plain BCE's all-negative minimum within epochs;
   1.0 is the reference's loss). MAT_EPOCH and RIG_EPOCH default to the reference's 10 and
   200 of 250 epochs, scaled to EPOCHS.
4. ``matching_data`` on the held-out split from the best checkpoint (the final state without
   one), into ``matching_data_<basename(MATCHER_OUT)>``: the reference's eval.sh.
5. When all three stages of ``synthetic_train_eval`` have checkpoints, the engine at batch 8
   twice: on the written matching data and on the GT-synthetic data, written as
   ``engine_matching_comparison.summary.json``. With any checkpoint missing it prints so and
   returns (the engine would fail to restore a partial set).

Summaries and metrics are collected into ``chiprun_out/evidence/gen<N_TRAIN>/<MATCHER_OUT>``.

``N_TRAIN=512 N_VAL=32 EPOCHS=120 BATCH=4 NUM_POINTS=2000 VAL_EVERY=10 POS_WEIGHT=4.0
[MAT_EPOCH=...] [RIG_EPOCH=...] CANONICALIZE=0 [MATCHER_OUT=...] python -m
puzzlefusion_plusplus_tpu_torch.scripts.matcher_train_eval [--cpu]``; CANONICALIZE=1 feeds the
encoder per-piece PCA frames (``matching/ops.py::pca_canonicalize``).
"""

from __future__ import annotations

import json
import os
import sys

import torch

from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device, run_inference
from puzzlefusion_plusplus_tpu_torch.matching.generate import generate_matching_data
from puzzlefusion_plusplus_tpu_torch.matching.oracle import oracle_matching_stats
from puzzlefusion_plusplus_tpu_torch.matching.train import make_model, train_matching
from puzzlefusion_plusplus_tpu_torch.scripts import (
    Clock,
    cli_device,
    env_int,
    run_root,
    stage_dir,
)
from puzzlefusion_plusplus_tpu_torch.scripts.evidence import collect, write_summary
from puzzlefusion_plusplus_tpu_torch.scripts.synthetic_train_eval import (
    ensure_splits,
    gen_config,
)
from puzzlefusion_plusplus_tpu_torch.training.state import best_checkpoint, load_model_state
from puzzlefusion_plusplus_tpu_torch.utils.config import Config

REFERENCE_SCHEDULE = "250 epochs, jigsaw_4x4_128_512_250e_cosine_everyday.yaml:13-20"
REFERENCE_LOOP = "eval.sh -> test.py, matching_base_model.py:274-454"
MODEL_SEED = 123  # train_matching's seed of its default model
NO_ENGINE = ("main-pipeline checkpoints incomplete (synthetic_train_eval.py still running?) — "
             "skipping the engine comparison")


def stage_epochs(epochs: int) -> tuple[int, int]:
    """(MAT_EPOCH, RIG_EPOCH) defaults: the reference's 10 and 200 of 250 epochs at EPOCHS."""
    return max(epochs * 10 // 250, 1), epochs * 200 // 250


def run(cfg: Config, root: str, n_train: int = 512, n_val: int = 32, epochs: int = 120,
        batch: int = 4, num_points: int = 2000, val_every: int = 10, pos_weight: float = 4.0,
        mat_epoch: int | None = None, rig_epoch: int | None = None,
        canonicalize: bool = False, matcher_out: str | None = None,
        model_kw: dict | None = None, log_every: int = 20, device=None,
        evidence_dir: str | None = None) -> dict:
    """The run in ``root`` -> {"oracle", "matcher_out", "checkpoint", "matching_data",
    "written", "edges", "comparison", "seconds"} ("comparison" None when a stage checkpoint
    is missing; "seconds" the wall time of each part). ``cfg`` holds the engine's widths;
    ``model_kw`` narrows the matcher (tests); ``log_every`` is the trainer's."""
    device = resolve_device(device)
    clock = Clock()
    seconds = {}

    def lap(name, t0):
        seconds[name] = clock.elapsed() - t0
        return clock.elapsed()

    default_mat, default_rig = stage_epochs(epochs)
    mat_epoch = default_mat if mat_epoch is None else mat_epoch
    rig_epoch = default_rig if rig_epoch is None else rig_epoch
    out = matcher_out or root + "/matcher_out"
    tag = f"gen{n_train}/{os.path.basename(out)}"
    ensure_splits(root, n_train, n_val, clock)
    train_dir, val_dir = root + "/pc_data/train", root + "/pc_data/val"

    t = lap("generate", 0.0)
    oracle = oracle_matching_stats(val_dir, num_points=num_points, num_shapes=min(n_val, 16))
    t = lap("oracle", t)
    clock.say(f"val oracle ceiling @ {num_points} pts: {json.dumps(oracle)}")
    clock.say(f"matcher: {epochs} epochs, batch {batch}, {num_points} pts, mat@{mat_epoch} "
              f"rig@{rig_epoch} canon={canonicalize}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(MODEL_SEED)
        model = make_model(canonicalize=canonicalize, **(model_kw or {}))
    state = train_matching(train_dir, out_dir=out, epochs=epochs, batch_size=batch,
                           num_points=num_points, mat_epoch=mat_epoch, rig_epoch=rig_epoch,
                           model=model, val_data_dir=val_dir, val_every=val_every,
                           cls_pos_weight=pos_weight, log_every=log_every, device=device)
    t = lap("train", t)
    clock.say("matcher training done")
    write_summary(out, "oracle_ceiling", {
        "oracle": oracle, "num_points": num_points, "n_train": n_train, "epochs": epochs,
        "canonicalize": canonicalize, "reference_schedule": REFERENCE_SCHEDULE})
    collect(out, tag, evidence_dir=evidence_dir)

    # matching_data from the trained matcher on the held-out split (the reference's eval.sh)
    best = best_checkpoint(out + "/ckpt")
    model = state.model
    if best is not None:
        model.load_state_dict(load_model_state(best))
        clock.say(f"generating matching_data from {best}")
    match_dir = root + "/matching_data_" + os.path.basename(out)  # one a matcher variant
    results = generate_matching_data(model, val_dir, match_dir, num_points=num_points, seed=0,
                                     device=device)
    n_edges = sum(r["num_edges"] for r in results)
    t = lap("write", t)
    clock.say(f"wrote {len(results)} shapes, {n_edges} edges -> {match_dir}")
    summary = {"oracle": oracle, "matcher_out": out, "checkpoint": best,
               "matching_data": match_dir, "written": len(results), "edges": n_edges,
               "comparison": None, "seconds": seconds}

    # the engine on the model's matching data and on the GT-synthetic data
    cfg = gen_config(root, cfg)
    ckpts = {s: stage_dir(cfg, s) + "/ckpt" for s in ("vqvae", "denoiser", "verifier")}
    if not all(os.path.isdir(d) for d in ckpts.values()):
        # all three stages or none: a partial set would fail the engine's restore
        print(NO_ENGINE, flush=True)
        return summary
    cfg.denoiser.encoder_ckpt_path = ckpts["vqvae"]
    cfg.denoiser.ckpt_path = ckpts["denoiser"]
    cfg.verifier.ckpt_path = ckpts["verifier"]
    cfg.inference.batch_size = 8
    cfg.inference.save_trajectories = False
    comparison = {}
    for name, path in (("model", match_dir), ("gt-synthetic", root + "/matching_data")):
        cfg.data.matching_data_path = path
        comparison[name] = run_inference(cfg, device)
        clock.say(f"engine metrics ({name} matching data): {json.dumps(comparison[name])}")
    write_summary(out, "engine_matching_comparison", {
        "comparison": comparison, "num_points": num_points, "n_val": n_val,
        "matcher_epochs": epochs, "pos_weight": pos_weight, "canonicalize": canonicalize,
        "reference_loop": REFERENCE_LOOP})
    collect(out, tag, evidence_dir=evidence_dir)
    lap("engine", t)
    summary["comparison"] = comparison
    return summary


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = cli_device(argv)
    n_train, epochs = env_int("N_TRAIN", 512), env_int("EPOCHS", 120)
    mat_epoch, rig_epoch = stage_epochs(epochs)
    root = run_root(f"gen_{n_train}")
    return run(Config(), root, n_train=n_train, n_val=env_int("N_VAL", 32), epochs=epochs,
               batch=env_int("BATCH", 4), num_points=env_int("NUM_POINTS", 2000),
               val_every=env_int("VAL_EVERY", 10),
               pos_weight=float(os.environ.get("POS_WEIGHT", "4.0")),
               mat_epoch=env_int("MAT_EPOCH", mat_epoch), rig_epoch=env_int("RIG_EPOCH", rig_epoch),
               canonicalize=os.environ.get("CANONICALIZE", "0") == "1",
               matcher_out=os.environ.get("MATCHER_OUT", root + "/matcher_out"), device=device)


if __name__ == "__main__":
    main()
