"""The overfit proof (port of ``scripts/overfit_proof.py``): all three stages trained on
NUM_SHAPES synthetic shapes at the production widths, until the engine's part_acc clears
the CD < 0.01 bar.

* Stage 1: the VQ-VAE (rotation-augmented) through ``training.vqvae.train``: the frozen
  encoder. Skipped once its checkpoints reach STEPS_AE.
* Stage 2: the denoiser overfit at batch 64 (each shape's fixed augmentation tiled), the
  timesteps drawn from the 20 inference timesteps (the AdaLN rows inference uses: with
  t ~ U[0, 1000) each row would get STEPS/1000 updates). Each step is ``overfit_step``.
  Every EVAL_EVERY steps (and after the first) a curve point holds the step's loss
  (``mse``, as the JAX script prints it), the mean loss since the last point
  (``mse_mean``), the loss on fixed draws (``mse_held``: the rows cycle through the 20
  timesteps, the noise from seed 1; the one of the three that no draw moves) and the
  sampler's metrics on one copy of each shape; the loop stops once part_acc exceeds 0.95.
  A checkpoint (with the curve and the step generator) is kept at each evaluation, so a cut
  run resumes where it was.
* Stage 3: the verifier on the synthetic verifier data, at batch 8 (below 10 shapes its
  80/20 split leaves less than a batch to train on, as in the JAX script: it takes no step).
* The engine: part_acc with merging disabled (threshold 1.1, a seeded verifier) and with
  the verifier stage's checkpoint (threshold 0.9), served from the stages' checkpoints.

The summary (``overfit.summary.json``: the curve, both engine results, the checkpoints, wall
times, peak memory, the device) goes with the trainers' metrics to
``chiprun_out/evidence/overfit<N>/`` (``evidence.collect``).

``NUM_SHAPES=1 STEPS_AE=1500 STEPS_DN=4000 STEPS_VF=400 EVAL_EVERY=250 python -m
puzzlefusion_plusplus_tpu_torch.scripts.overfit_proof [--cpu]``; the run root is
``<tmp>/pfpp_torch_overfit_<NUM_SHAPES>``.
"""

from __future__ import annotations

import copy
import os
import shutil
import sys

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.data import DenoiserDataset, generate_dataset
from puzzlefusion_plusplus_tpu_torch.inference.run import (
    SAMPLE_KEYS,
    build_engine_fn,
    resolve_device,
)
from puzzlefusion_plusplus_tpu_torch.inference.sampler import FrozenEncoder, extract_features
from puzzlefusion_plusplus_tpu_torch.models.scheduler import (
    DDPMParams,
    add_noise,
    leading_timesteps,
)
from puzzlefusion_plusplus_tpu_torch.scripts import (
    Clock,
    cli_device,
    env_int,
    run_root,
    stage_dir,
    trained_steps,
)
from puzzlefusion_plusplus_tpu_torch.scripts.evidence import collect, write_summary
from puzzlefusion_plusplus_tpu_torch.training import verifier as tvf
from puzzlefusion_plusplus_tpu_torch.training import vqvae as tvq
from puzzlefusion_plusplus_tpu_torch.training.denoiser import (
    draw_step_noise,
    eval_metrics,
    load_frozen_encoder,
    make_model,
    make_sample_fn,
)
from puzzlefusion_plusplus_tpu_torch.training.state import (
    TrainState,
    adamw_reference,
    maybe_restore,
    save_checkpoint,
)
from puzzlefusion_plusplus_tpu_torch.training.vqvae import to_device
from puzzlefusion_plusplus_tpu_torch.utils.config import Config

BATCH = 64
PART_ACC_BAR = 0.95
# in a stage-2 checkpoint dir: the curve, the step generator, whether the bar was cleared
PROGRESS = "overfit_progress.pt"
# label, threshold, whether the verifier stage's checkpoint serves (else seeded weights)
ENGINE_RUNS = (("no-merge", 1.1, False), ("full", 0.9, True))


def make_config(root: str, cfg: Config | None = None) -> Config:
    """``cfg`` (``Config()`` by default; its widths are kept) pointed at the run root: one
    split for training and evaluation, batch 1, one device, no dropout."""
    cfg = copy.deepcopy(cfg) if cfg is not None else Config()
    cfg.data.data_dir = cfg.data.data_val_dir = root + "/pc_data/val"
    cfg.data.matching_data_path = root + "/matching_data"
    cfg.data.verifier_data_path = root + "/verifier_data"
    cfg.data.batch_size = cfg.data.val_batch_size = 1
    cfg.trainer.output_dir = root + "/out"
    cfg.trainer.num_devices = 1
    cfg.denoiser.dropout = cfg.denoiser.pe_dropout = 0.0
    return cfg


def make_fixed_batch(cfg: Config, batch: int = BATCH):
    """-> (the fixed samples, one per shape, each drawn from ``default_rng(42 + i)``; their
    numeric fields tiled to ``batch // len(fixed)`` copies each, as numpy)."""
    ds = DenoiserDataset(cfg.data.data_val_dir, mode="test",
                         matching_data_path=cfg.data.matching_data_path,
                         max_num_part=cfg.data.max_num_part, multiple_ref_parts=False)
    fixed = [ds.get(i, np.random.default_rng(42 + i)) for i in range(len(ds))]
    reps = batch // len(fixed)
    tiled = {k: np.stack([np.asarray(s[k]) for s in fixed for _ in range(reps)])
             for k in fixed[0]
             if isinstance(fixed[0][k], (np.ndarray, np.generic, int, float))}
    return fixed, tiled


def overfit_loss(model: torch.nn.Module, encoder: FrozenEncoder, ddpm: DDPMParams,
                 batch: dict, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The overfit loss at timesteps ``t`` [B] and noise [B, P, 7]: the GT poses noised at
    ``t`` with the reference parts held at the GT, the clouds encoded at the noisy
    rotations by the composable encode with nothing cached (kernels F, G, A), the denoiser
    in eval mode (the JAX step's ``train=False``) on the detached features, and the MSE of
    the predicted noise over the valid non-reference parts."""
    gt = torch.cat([batch["part_trans"], batch["part_rots"]], -1)
    ref = batch["ref_part"].bool()
    noisy = torch.where(ref[..., None], gt, add_noise(ddpm, gt, noise, t))
    with torch.no_grad():  # the JAX step's stop_gradient on the frozen encoder's features
        latent, xyz = extract_features(encoder, batch["part_pcs"], noisy, None,
                                       batch["part_valids"])
    model.eval()
    pred = model(noisy, t, latent, xyz, batch["part_valids"], batch["part_scale"], ref)
    w = ((batch["part_valids"] > 0) & ~ref)[..., None].to(pred.dtype)
    return ((pred - noise) ** 2 * w).sum() / (w.sum() * 7.0).clamp_min(1.0)


def overfit_step(model: torch.nn.Module, opt: torch.optim.Optimizer, encoder: FrozenEncoder,
                 ddpm: DDPMParams, batch: dict, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
    """One AdamW step on ``overfit_loss`` -> the loss (0-d, not synchronised)."""
    loss = overfit_loss(model, encoder, ddpm, batch, t, noise)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def held_draws(ddpm: DDPMParams, shape: tuple, timestep_set: torch.Tensor, device):
    """Fixed draws for ``mse_held``: the rows cycle through the timesteps of
    ``timestep_set``, the noise comes from seed 1."""
    t = timestep_set[torch.arange(shape[0], device=device) % timestep_set.shape[0]]
    return t, torch.randn(shape, generator=torch.Generator(device=device).manual_seed(1),
                          device=device)


def sample_metrics(sample_fn, batch: dict, device) -> dict:
    """The sampler's mean metrics on ``batch``, its noise from seed 0."""
    final, _ = sample_fn(batch, torch.Generator(device=device).manual_seed(0))
    return {k: float(v.float().mean()) for k, v in eval_metrics(final, batch).items()}


def _save(state: TrainState, ckpt_dir: str, curve: list, done: bool,
          generator: torch.Generator) -> str:
    """A checkpoint with the loop's progress in it; the older ones are dropped."""
    path = save_checkpoint(ckpt_dir, state)
    tmp = os.path.join(path, PROGRESS + ".tmp")
    torch.save({"curve": curve, "done": done, "generator": generator.get_state()}, tmp)
    os.replace(tmp, os.path.join(path, PROGRESS))
    for d in os.listdir(ckpt_dir):
        old = os.path.join(ckpt_dir, d)
        if d.startswith("step_") and old != path:
            shutil.rmtree(old)
    return path


def _resume(state: TrainState, ckpt_dir: str, generator: torch.Generator):
    """Restore the latest checkpoint that holds the loop's progress -> (curve, done)."""
    steps = [os.path.join(ckpt_dir, d) for d in os.listdir(ckpt_dir)
             if os.path.exists(os.path.join(ckpt_dir, d, PROGRESS))
             ] if os.path.isdir(ckpt_dir) else []
    if not steps:
        return [], False
    saved = max(steps, key=lambda p: int(p.rsplit("_", 1)[1]))
    maybe_restore(state, ckpt_dir, saved)
    progress = torch.load(os.path.join(saved, PROGRESS), weights_only=True)
    generator.set_state(progress["generator"])
    return progress["curve"], bool(progress["done"])


def overfit_denoiser(cfg: Config, encoder: FrozenEncoder, batch: dict, eval_batch: dict,
                     steps: int, eval_every: int, device, clock: Clock) -> dict:
    """Stage 2 -> {checkpoint, curve, steps, s_per_step (the steps run in this call, their
    evaluations left out)}."""
    d = cfg.denoiser
    ddpm = DDPMParams.piecewise(d.ddpm_train_steps)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        model = make_model(cfg).to(device)
    state = adamw_reference(model, d.lr)
    ckpt_dir = stage_dir(cfg, "denoiser") + "/ckpt"
    generator = torch.Generator(device=device).manual_seed(7)
    curve, done = _resume(state, ckpt_dir, generator)
    timestep_set = torch.as_tensor(leading_timesteps(d.ddpm_train_steps,
                                                     d.num_inference_steps), device=device)
    sample_fn = make_sample_fn(model, encoder, ddpm, d.num_inference_steps)
    shape = tuple(batch["part_trans"].shape[:2]) + (7,)
    held = held_draws(ddpm, shape, timestep_set, device)
    first, t_loop, t_eval = state.step, clock.elapsed(), 0.0
    window = []  # the losses since the last evaluation
    while not done and state.step < steps:
        t, noise = draw_step_noise(ddpm, shape, generator, timestep_set, device)
        window.append(overfit_step(model, state.optimizer, encoder, ddpm, batch, t, noise))
        state.step += 1
        if state.step % eval_every == 0 or state.step == 1:
            t0 = clock.elapsed()
            with torch.no_grad():
                mse_held = float(overfit_loss(model, encoder, ddpm, batch, *held))
            point = {"step": state.step, "mse": float(window[-1]),
                     "mse_mean": float(torch.stack(window).mean()), "mse_held": mse_held,
                     **sample_metrics(sample_fn, eval_batch, device)}
            window = []
            t_eval += clock.elapsed() - t0
            curve.append({**point, "wall_s": clock.elapsed()})
            clock.say(f"step {state.step}: " + " ".join(
                f"{k}={v:.4f}" for k, v in point.items() if k != "step"))
            done = point["part_acc"] > PART_ACC_BAR
            if done:
                clock.say("part_acc bar cleared, stopping early")
            _save(state, ckpt_dir, curve, done, generator)
    path = _save(state, ckpt_dir, curve, done, generator)
    ran = state.step - first
    return {"checkpoint": path, "curve": curve, "steps": state.step,
            "s_per_step": (clock.elapsed() - t_loop - t_eval) / ran if ran else None}


def run_engine(cfg: Config, fixed: list, dn_ckpt: str, vf_ckpt: str, device) -> dict:
    """The engine over the fixed samples, without merging and with the verifier stage's
    checkpoint."""
    sample = {k: np.stack([np.asarray(s[k]) for s in fixed]) for k in SAMPLE_KEYS}
    out = {}
    for label, threshold, trained_verifier in ENGINE_RUNS:
        ecfg = copy.deepcopy(cfg)
        ecfg.denoiser.ckpt_path = dn_ckpt
        ecfg.verifier.threshold = threshold
        ecfg.verifier.ckpt_path = vf_ckpt if trained_verifier else ""
        engine = build_engine_fn(ecfg, device)
        res = engine(sample, generator=torch.Generator(device=device).manual_seed(0))
        out[label] = {**{k: float(np.mean(res[k])) for k in
                         ("part_acc", "part_acc_nonref", "shape_cd", "rmse_r", "rmse_t")},
                      "merged_pairs": int(np.sum(res["n_merged_pairs"])),
                      "n_iters": int(np.max(res["n_iters"])), "threshold": threshold,
                      "verifier": ecfg.verifier.ckpt_path or "seeded"}
    return out


def run(cfg: Config, root: str, num_shapes: int = 1, steps_ae: int = 1500,
        steps_dn: int = 4000, steps_vf: int = 400, eval_every: int = 250,
        batch: int = BATCH, device=None,
        evidence_dir: str | None = None) -> dict:
    """The whole proof in ``root`` at ``cfg``'s widths -> the summary it writes."""
    device = resolve_device(device)
    clock = Clock()
    cfg = make_config(root, cfg)
    if not os.path.exists(root + "/.done"):
        generate_dataset(root, num_shapes=num_shapes, seed=3, split="val", min_parts=4,
                         max_parts=6, n_points=1000)
        with open(root + "/.done", "w") as fh:
            fh.write("ok")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    seconds, mark = {}, [0.0]

    def lap(stage):
        seconds[stage] = clock.elapsed() - mark[0]
        mark[0] = clock.elapsed()

    lap("data")

    ae_ckpt = stage_dir(cfg, "vqvae") + "/ckpt"
    if trained_steps(ae_ckpt) < steps_ae:
        clock.say(f"stage 1: VQ-VAE {steps_ae} steps")
        tvq.train(cfg, max_steps=steps_ae, device=device)
    lap("vqvae")
    cfg.denoiser.encoder_ckpt_path = ae_ckpt

    encoder = load_frozen_encoder(cfg, device)
    fixed, tiled = make_fixed_batch(cfg, batch)
    train_batch = to_device(tiled, device)
    reps = batch // len(fixed)
    eval_batch = {k: v[::reps] for k, v in train_batch.items()}  # one copy of each shape
    clock.say(f"stage 2: denoiser overfit, batch {len(tiled['part_pcs'])}")
    den = overfit_denoiser(cfg, encoder, train_batch, eval_batch, steps_dn, eval_every,
                           device, clock)
    lap("denoiser")

    clock.say(f"stage 3: verifier {steps_vf} steps")
    vf_ckpt = stage_dir(cfg, "verifier") + "/ckpt"
    vcfg = copy.deepcopy(cfg)
    vcfg.data.batch_size = vcfg.data.val_batch_size = 8
    if trained_steps(vf_ckpt) < steps_vf:
        tvf.train(vcfg, max_steps=steps_vf, device=device)
    lap("verifier")

    engine = run_engine(cfg, fixed, den["checkpoint"], vf_ckpt, device)
    lap("engine")
    for label, res in engine.items():
        clock.say(f"engine[{label}]: " + " ".join(
            f"{k}={res[k]:.4f}" for k in ("part_acc", "shape_cd", "rmse_r", "rmse_t"))
            + f" merged_pairs={res['merged_pairs']}")
    summary = {
        "curve": den["curve"], "engine": engine, "num_shapes": num_shapes,
        # "verifier_trained": the steps the verifier took. The 80/20 file split leaves fewer
        # training files than a batch of 8 below 10 shapes (one file a shape), and the
        # loader drops a short batch, so there the verifier keeps its seeded weights, as in
        # the JAX script.
        "steps": {"vqvae": steps_ae, "denoiser": den["steps"], "denoiser_max": steps_dn,
                  "verifier": steps_vf, "verifier_trained": trained_steps(vf_ckpt),
                  "eval_every": eval_every},
        "batch": len(tiled["part_pcs"]), "denoiser_s_per_step": den["s_per_step"],
        "checkpoints": {"vqvae": ae_ckpt, "denoiser": den["checkpoint"], "verifier": vf_ckpt},
        "seconds": seconds, "wall_s": clock.elapsed(),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
    }
    out_dir = cfg.trainer.output_dir
    write_summary(out_dir, "overfit", summary)
    collect(out_dir, f"overfit{num_shapes}", evidence_dir=evidence_dir)
    return summary


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = cli_device(argv)
    n = env_int("NUM_SHAPES", 1)
    return run(Config(), run_root(f"overfit_{n}"), num_shapes=n,
               steps_ae=env_int("STEPS_AE", 1500), steps_dn=env_int("STEPS_DN", 4000),
               steps_vf=env_int("STEPS_VF", 400), eval_every=env_int("EVAL_EVERY", 250),
               device=device)


if __name__ == "__main__":
    main()
