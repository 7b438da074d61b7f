"""Verifier-data provenance A/B (port of ``scripts/verifier_regen_eval.py``):
synthetic-perturbation labels against labels from the trained denoiser.

The reference's verifier data comes from ITS trained denoiser (docs/data_preparation.md;
schema verifier/dataset/dataset.py:50-53): the verifier learns the failure modes of the
sampler it gates. ``synthetic_train_eval``'s verifier trains on the synthetic-perturbation
tree (``data/synthetic.py::make_verifier_data_npz``) instead. This closes the loop:

1. regenerate verifier data from the best denoiser checkpoint (``data/verifier_gen.py``:
   the 20-step sampler on each training shape); ``.vfdata_dn`` in the run root marks it;
2. train a fresh verifier on it (output ``out_dnvf/``);
3. run the held-out engine with both verifiers and write the comparison, merged pairs
   included (the question is whether the verifier gates merges).

``N_TRAIN=4096 MAX_SAMPLES=1500 ROUNDS=1 STEPS_VF=1000 EVAL_OVERFIT=-1 python -m
puzzlefusion_plusplus_tpu_torch.scripts.verifier_regen_eval [--cpu]`` on the run root
``<tmp>/pfpp_torch_gen_<N_TRAIN>``; the evidence goes to ``gen<N_TRAIN>/verifier_dn``.
"""

from __future__ import annotations

import json
import os
import sys

from puzzlefusion_plusplus_tpu_torch.data.verifier_gen import generate_verifier_data
from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device, run_inference
from puzzlefusion_plusplus_tpu_torch.scripts import (
    Clock,
    cli_device,
    env_int,
    run_root,
    stage_dir,
)
from puzzlefusion_plusplus_tpu_torch.scripts.eval_train_split import make_sampler
from puzzlefusion_plusplus_tpu_torch.scripts.evidence import collect, write_summary
from puzzlefusion_plusplus_tpu_torch.scripts.synthetic_train_eval import gen_config
from puzzlefusion_plusplus_tpu_torch.training import verifier as tvf
from puzzlefusion_plusplus_tpu_torch.training.state import best_checkpoint
from puzzlefusion_plusplus_tpu_torch.utils.config import Config

NOTE = ("reference provenance: verifier data generated by the trained denoiser "
        "(docs/data_preparation.md); synthetic_train_eval used synthetic-perturbation labels")


def run(cfg: Config, root: str, n_train: int = 4096, max_samples: int = 1500,
        rounds: int = 1, steps_vf: int = 1000, eval_overfit: int = -1,
        verifier_batch: int = 64, engine_batch: int = 8, bucket_mult: int = 4, device=None,
        evidence_dir: str | None = None) -> dict:
    """The A/B on ``root`` at ``cfg``'s widths -> the summary it writes."""
    device = resolve_device(device)
    clock = Clock()
    cfg = gen_config(root, cfg, bucket_mult)
    vf_data, dn_out = root + "/verifier_data_dn", root + "/out_dnvf"
    tag = f"gen{n_train}/verifier_dn"

    marker = root + "/.vfdata_dn"
    if not os.path.exists(marker):
        best = best_checkpoint(stage_dir(cfg, "denoiser") + "/ckpt")
        if best is None:
            raise FileNotFoundError(f"no denoiser checkpoint under {root}")
        clock.say(f"generating verifier data from {best}")
        n = generate_verifier_data(
            make_sampler(cfg, best, device), root + "/pc_data/train", root + "/matching_data",
            vf_data, max_num_part=cfg.data.max_num_part, max_samples=max_samples,
            rounds=rounds, device=device)
        clock.say(f"wrote {n} verifier samples -> {vf_data}")
        with open(marker, "w") as fh:
            fh.write(str(n))

    vcfg = gen_config(root, cfg, bucket_mult)
    vcfg.data.verifier_data_path = vf_data
    vcfg.trainer.output_dir = dn_out
    vcfg.data.batch_size = vcfg.data.val_batch_size = verifier_batch
    clock.say(f"training verifier on denoiser data ({steps_vf} steps)")
    tvf.train(vcfg, max_steps=steps_vf, device=device)
    collect(stage_dir(vcfg, "verifier"), tag, evidence_dir=evidence_dir)

    comparison = {}
    for label, vf_ckpt in (("synthetic-verifier", stage_dir(cfg, "verifier") + "/ckpt"),
                           ("denoiser-verifier", stage_dir(vcfg, "verifier") + "/ckpt")):
        ecfg = gen_config(root, cfg, bucket_mult)
        ecfg.trainer.output_dir = dn_out
        ecfg.trainer.experiment_name = "engine_" + label
        ecfg.denoiser.ckpt_path = stage_dir(cfg, "denoiser") + "/ckpt"
        ecfg.verifier.ckpt_path = vf_ckpt
        ecfg.data.overfit = eval_overfit
        ecfg.inference.batch_size = engine_batch
        ecfg.inference.save_trajectories = False
        ecfg.inference.save_breakdown = True
        agg = run_inference(ecfg, device)
        agg["total_merged_pairs"] = agg["n_merged_pairs"]
        comparison[label] = agg
        clock.say(f"engine ({label}): {json.dumps(agg)}")

    eng_dir = dn_out + "/engine_eval"
    os.makedirs(eng_dir, exist_ok=True)
    summary = {"comparison": comparison, "n_train": n_train, "max_samples": max_samples,
               "steps_vf": steps_vf, "note": NOTE}
    write_summary(eng_dir, "verifier_provenance_engine", summary)
    collect(eng_dir, tag, evidence_dir=evidence_dir)
    clock.say("done")
    return summary


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = cli_device(argv)
    n_train = env_int("N_TRAIN", 4096)
    return run(Config(), run_root(f"gen_{n_train}"), n_train=n_train,
               max_samples=env_int("MAX_SAMPLES", 1500), rounds=env_int("ROUNDS", 1),
               steps_vf=env_int("STEPS_VF", 1000), eval_overfit=env_int("EVAL_OVERFIT", -1),
               device=device)


if __name__ == "__main__":
    main()
