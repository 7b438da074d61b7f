"""The synthetic generalization run (port of ``scripts/synthetic_train_eval.py``): all
three stages trained on N_TRAIN synthetic shapes through the production training loops,
then the whole engine on HELD-OUT shapes.

Unlike ``overfit_proof`` this measures generalization: train and val are disjoint shape
sets, the augmentation is the reference pipeline (fresh rotations every epoch, the multi-ref
curriculum), and the checkpoint is chosen by the top-k retention on eval part_acc.

* Stage 1, the VQ-VAE at batch 16, plateau-gated on ``cd_loss`` (``evidence.loss_plateaued``,
  window 10): it extends by half its budget until the series plateaus or PLATEAU_X times
  the budget is reached; ``.stage1_plateau`` in the run root marks it done.
* Stage 2, the denoiser at batch 64 (val 16) on the 20 inference timesteps, validating every
  ``max(base_epochs // 40, 1)`` epochs, plateau-gated on ``eval_part_acc`` (window 5, 1%,
  mode 'max'); ``.stage2_plateau`` marks it done.
* Stage 3, the verifier for STEPS_VF steps at batch 64.
* The held-out engine at batch 8 (``run_inference`` with ``save_breakdown``), its
  ``engine_breakdown.analyze`` tables (an analysis error lands in the summary; the metrics
  are kept), and ``heldout_engine.summary.json`` beside the reference's bar.

Every stage's metrics are collected into ``chiprun_out/evidence/gen<N_TRAIN>/`` when it ends.
Unlike the JAX script, the run refuses to start when the denoiser's bucketed loader holds
no batch (every part bucket smaller than the batch): there the JAX script trains the
denoiser 0 steps, as it does at its own defaults (256 shapes of 2-20 parts leave 45-60 shapes
in each of the 5 buckets of 4, under the batch of 64). ``N_TRAIN=512`` trains.

``N_TRAIN=256 N_VAL=16 STEPS_AE=4000 STEPS_DN=10000 STEPS_VF=1000 MIN_PARTS=2 MAX_PARTS=20
PLATEAU_X=3 BUCKET_MULT=4 python -m puzzlefusion_plusplus_tpu_torch.scripts.
synthetic_train_eval [--cpu]``; the run root is ``<tmp>/pfpp_torch_gen_<N_TRAIN>``.
"""

from __future__ import annotations

import copy
import json
import os
import sys

from puzzlefusion_plusplus_tpu_torch.data import DenoiserDataset, Loader, generate_dataset
from puzzlefusion_plusplus_tpu_torch.data.bucketing import bucket_keys
from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device, run_inference
from puzzlefusion_plusplus_tpu_torch.scripts import (
    Clock,
    cli_device,
    env_int,
    run_root,
    stage_dir,
)
from puzzlefusion_plusplus_tpu_torch.scripts.engine_breakdown import analyze, load_records
from puzzlefusion_plusplus_tpu_torch.scripts.evidence import (
    collect,
    loss_plateaued,
    write_summary,
)
from puzzlefusion_plusplus_tpu_torch.training import denoiser as tden
from puzzlefusion_plusplus_tpu_torch.training import verifier as tvf
from puzzlefusion_plusplus_tpu_torch.training import vqvae as tvq
from puzzlefusion_plusplus_tpu_torch.utils.config import Config

REFERENCE_BAR = {"part_acc": 0.7018, "source": "docs/test.md:17", "nonref_equivalent": 0.65}
# batch sizes of the stages: VQ-VAE, denoiser (train, val), verifier, the held-out engine
BATCHES = {"vqvae": 16, "denoiser": 64, "denoiser_val": 16, "verifier": 64, "engine": 8}


def gen_config(root: str, cfg: Config | None = None, bucket_mult: int = 4) -> Config:
    """``cfg`` (``Config()`` by default; its widths are kept) pointed at a generalization run
    root: ``pc_data/{train,val}``, ``matching_data``, ``verifier_data``, outputs in
    ``out/``, one device, part-count bucketing at ``bucket_mult``."""
    cfg = copy.deepcopy(cfg) if cfg is not None else Config()
    cfg.data.data_dir = root + "/pc_data/train"
    cfg.data.data_val_dir = root + "/pc_data/val"
    cfg.data.matching_data_path = root + "/matching_data"
    cfg.data.verifier_data_path = root + "/verifier_data"
    cfg.trainer.output_dir = root + "/out"
    cfg.trainer.num_devices = 1
    # part-count bucketing of the training loops (the losses mask the pad)
    cfg.data.part_bucket_multiple = bucket_mult
    cfg.denoiser.encoder_ckpt_path = stage_dir(cfg, "vqvae") + "/ckpt"
    return cfg


def denoiser_batches(cfg: Config, batch: int) -> int:
    """The batches an epoch of the denoiser trainer's loader at ``batch``: batches form within
    each part bucket and a bucket's short tail is dropped (``training/denoiser.py``)."""
    ds = DenoiserDataset(cfg.data.data_dir, mode="train", max_num_part=cfg.data.max_num_part,
                         multiple_ref_parts=cfg.denoiser.multiple_ref_parts,
                         overfit=cfg.data.overfit)
    keys = bucket_keys(ds, cfg.data.part_bucket_multiple, cfg.data.max_num_part)
    return len(Loader(ds, batch, seed=cfg.trainer.seed, bucket_key=keys))


def ensure_splits(root: str, n_train: int, n_val: int, clock: Clock, min_parts: int = 2,
                  max_parts: int = 20) -> None:
    """The run root's shapes, made once (``.done`` marks them): N_TRAIN training shapes
    (seed 11) and N_VAL held-out ones (seed 12) of 1000 points, as the JAX scripts that share
    the root (``synthetic_train_eval``, ``matcher_train_eval``) make them."""
    if not os.path.exists(root + "/.done"):
        clock.say(f"generating {n_train}+{n_val} shapes")
        generate_dataset(root, num_shapes=n_train, seed=11, split="train",
                         min_parts=min_parts, max_parts=max_parts, n_points=1000)
        generate_dataset(root, num_shapes=n_val, seed=12, split="val", min_parts=min_parts,
                         max_parts=max_parts, n_points=1000)
        with open(root + "/.done", "w") as fh:
            fh.write("ok")


def run(cfg: Config, root: str, n_train: int = 256, n_val: int = 16, steps_ae: int = 4000,
        steps_dn: int = 10000, steps_vf: int = 1000, min_parts: int = 2, max_parts: int = 20,
        plateau_x: float = 3.0, bucket_mult: int = 4, batches: dict | None = None,
        device=None, evidence_dir: str | None = None) -> dict:
    """The whole run in ``root`` at ``cfg``'s widths -> the held-out summary."""
    device = resolve_device(device)
    batches = {**BATCHES, **(batches or {})}
    clock = Clock()
    tag = f"gen{n_train}"
    ensure_splits(root, n_train, n_val, clock, min_parts, max_parts)
    cfg = gen_config(root, cfg, bucket_mult)
    if not os.path.exists(root + "/.stage2_plateau") and not denoiser_batches(
            cfg, batches["denoiser"]):
        # the JAX script trains the denoiser 0 steps here, silently (its defaults do so:
        # 256 shapes of 2-20 parts leave 45-60 in each of the 5 buckets, under 64)
        raise ValueError(
            f"no denoiser training batch: every part bucket (BUCKET_MULT={bucket_mult}) of the "
            f"{n_train} training shapes holds fewer than {batches['denoiser']}; raise N_TRAIN "
            "or lower BUCKET_MULT")

    # stage 1, plateau-gated: a fixed budget can leave cd_loss still falling at the cut
    if not os.path.exists(root + "/.stage1_plateau"):
        cfg.data.batch_size = cfg.data.val_batch_size = batches["vqvae"]
        target = steps_ae
        while True:
            clock.say(f"stage 1: VQ-VAE -> step {target}")
            tvq.train(cfg, max_steps=target, device=device)  # resumes from the latest
            done, info = loss_plateaued(stage_dir(cfg, "vqvae") + "/metrics.jsonl", "cd_loss",
                                        window=10)
            clock.say(f"stage 1 plateau check: done={done} {info}")
            if done or target >= steps_ae * plateau_x:
                break
            target += max(steps_ae // 2, 1)
        with open(root + "/.stage1_plateau", "w") as fh:
            fh.write(str(info))
    collect(stage_dir(cfg, "vqvae"), f"{tag}/vqvae", evidence_dir=evidence_dir)

    # stage 2: the production loop, validated every val_every epochs (the part_acc curve),
    # plateau-gated on eval_part_acc
    cfg.data.batch_size, cfg.data.val_batch_size = batches["denoiser"], batches["denoiser_val"]
    cfg.denoiser.train_on_inference_timesteps = True
    steps_per_epoch = max(n_train // cfg.data.batch_size, 1)
    base_epochs = -(-steps_dn // steps_per_epoch)
    # a dense validation cadence: each validation checkpoints the run
    cfg.denoiser.val_every = max(base_epochs // 40, 1)
    if not os.path.exists(root + "/.stage2_plateau"):
        epochs = base_epochs
        while True:
            clock.say(f"stage 2: denoiser -> epoch {epochs} (~{epochs * steps_per_epoch} "
                      "steps)")
            cfg.denoiser.epochs = epochs
            tden.train(cfg, device=device)
            done, info = loss_plateaued(stage_dir(cfg, "denoiser") + "/metrics.jsonl",
                                        "eval_part_acc", window=5, min_rel_improve=0.01,
                                        mode="max")
            clock.say(f"stage 2 plateau check: done={done} {info}")
            if done or epochs >= base_epochs * plateau_x:
                break
            epochs += max(base_epochs // 2, 1)
        with open(root + "/.stage2_plateau", "w") as fh:
            fh.write(str(info))
    collect(stage_dir(cfg, "denoiser"), f"{tag}/denoiser", evidence_dir=evidence_dir)

    # stage 3
    clock.say(f"stage 3: verifier {steps_vf} steps")
    cfg.data.batch_size = cfg.data.val_batch_size = batches["verifier"]
    tvf.train(cfg, max_steps=steps_vf, device=device)
    collect(stage_dir(cfg, "verifier"), f"{tag}/verifier", evidence_dir=evidence_dir)

    # the engine on the held-out shapes (the best denoiser checkpoint by its top-k index)
    cfg.denoiser.ckpt_path = stage_dir(cfg, "denoiser") + "/ckpt"
    cfg.verifier.ckpt_path = stage_dir(cfg, "verifier") + "/ckpt"
    cfg.inference.batch_size = batches["engine"]
    cfg.inference.save_trajectories = False
    cfg.inference.save_breakdown = True  # per-part records for engine_breakdown
    agg = run_inference(cfg, device)
    clock.say(f"HELD-OUT engine metrics: {agg}")
    eng_dir = cfg.trainer.output_dir + "/engine_eval"
    os.makedirs(eng_dir, exist_ok=True)
    inf_dir = os.path.join(cfg.trainer.output_dir, cfg.trainer.experiment_name, "inference",
                           cfg.inference.inference_dir)
    try:
        breakdown = analyze(load_records(inf_dir))
    except Exception as e:  # noqa: BLE001 — an analysis error must not lose the metrics
        breakdown = {"error": repr(e)}
    clock.say(f"per-part breakdown: {json.dumps(breakdown)}")
    summary = {"metrics": agg, "n_train": n_train, "n_val": n_val, "min_parts": min_parts,
               "max_parts": max_parts, "breakdown": breakdown, "reference_bar": REFERENCE_BAR}
    write_summary(eng_dir, "heldout_engine", summary)
    collect(eng_dir, f"{tag}/engine", evidence_dir=evidence_dir)
    return summary


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = cli_device(argv)
    n_train = env_int("N_TRAIN", 256)
    return run(Config(), run_root(f"gen_{n_train}"), n_train=n_train,
               n_val=env_int("N_VAL", 16), steps_ae=env_int("STEPS_AE", 4000),
               steps_dn=env_int("STEPS_DN", 10000), steps_vf=env_int("STEPS_VF", 1000),
               min_parts=env_int("MIN_PARTS", 2), max_parts=env_int("MAX_PARTS", 20),
               plateau_x=float(os.environ.get("PLATEAU_X", "3")),
               bucket_mult=env_int("BUCKET_MULT", 4), device=device)


if __name__ == "__main__":
    main()
