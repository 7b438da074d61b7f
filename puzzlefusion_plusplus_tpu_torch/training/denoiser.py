"""Stage-2 denoiser training (port of ``puzzlefusion_plusplus_tpu/training/denoiser.py``).

``python -m puzzlefusion_plusplus_tpu_torch.training.denoiser data.data_dir=...
data.data_val_dir=... [denoiser.encoder_ckpt_path=<stage-1 ckpt dir>]`` trains on the GPU
(``--cpu`` for the CPU), with the JAX package's config keys. Semantics (reference
denoiser/model/denoiser.py):

* loss: t ~ U[0, 1000) per shape (or from the 20 inference timesteps with
  ``denoiser.train_on_inference_timesteps``), DDPM noise on the GT 7-DoF poses with the
  reference parts pinned to GT, frozen-encoder features of the rotated clouds, and the MSE of
  the predicted noise over the valid non-reference parts.
* the frozen encoder runs under ``torch.no_grad()``: the single-shot composable encode
  (kernels F, G, A), or with ``denoiser.train_encode_cached`` the engine's cached-geometry
  path (kernel S).
* validation: the 20-step reverse loop (kernel S) and the assembly metrics; top-k
  checkpoints on ``eval_part_acc`` ranked on a trailing mean (``trainer.ckpt_smooth_k``).
* optimizer: AdamW lr 2e-4, betas (0.95, 0.999), weight decay 1e-6.
* ``trainer.precision=bf16``: the denoiser computes in bf16 (``models/denoiser.py``) and the
  frozen encoder's composable encode too (``models/vqvae.py``); with
  ``denoiser.train_encode_cached`` and in validation, kernel S keeps its fp32 weights, as the
  JAX package's fused-cached encode does on a TPU. Parameters, gradients and AdamW's state
  stay fp32.

The stage-1 encoder comes from a checkpoint of ``training.vqvae`` (the port's format), or is
untrained and seeded when no path is given.

``trainer.num_devices`` above 1 trains data-parallel (``parallel/``, as ``training.vqvae``):
the MSE is normalised by the global batch's count, the timesteps, the diffusion noise and the
validation sampler's noise are drawn for the global batch from one seeded generator on every
rank and then sliced (so the draws do not depend on the world size), and the ranks' dropout
seeds differ by their rank.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.data.bucketing import part_bucket, slice_batch_parts
from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset
from puzzlefusion_plusplus_tpu_torch.data.loader import Loader, prefetch_batches
from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device
from puzzlefusion_plusplus_tpu_torch.inference.sampler import (
    FrozenEncoder,
    build_feature_cache,
    ddpm_sample,
    extract_features,
    make_frozen_encoder,
)
from puzzlefusion_plusplus_tpu_torch.models.denoiser import DenoiserTransformer, compute_dtype
from puzzlefusion_plusplus_tpu_torch.models.denoiser import make_denoiser as make_model
from puzzlefusion_plusplus_tpu_torch.models.scheduler import (
    DDPMParams,
    add_noise,
    leading_timesteps,
)
from puzzlefusion_plusplus_tpu_torch.parallel import launch, mesh
from puzzlefusion_plusplus_tpu_torch.training.state import (
    MetricsLogger,
    TopKCheckpointer,
    TrainState,
    adamw_reference,
    load_model_state,
    maybe_restore,
    save_checkpoint,
)
from puzzlefusion_plusplus_tpu_torch.training.vqvae import local_rows
from puzzlefusion_plusplus_tpu_torch.training.vqvae import make_model as make_ae_model
from puzzlefusion_plusplus_tpu_torch.utils import profiling
from puzzlefusion_plusplus_tpu_torch.utils.config import Config, config_from_argv
from puzzlefusion_plusplus_tpu_torch.utils.metrics import assembly_metrics

EVAL_KEYS = ("part_acc", "part_acc_nonref", "shape_cd", "rmse_r", "rmse_t")


def _gt(batch: dict) -> torch.Tensor:
    return torch.cat([batch["part_trans"], batch["part_rots"]], dim=-1)  # [B, P, 7]


def draw_step_noise(ddpm: DDPMParams, shape, generator: torch.Generator | None,
                    timestep_set: torch.Tensor | None = None, device=None):
    """(timesteps [B], noise [B, P, 7]) of one training step for poses of ``shape``, drawn
    from ``generator`` in that order; ``timestep_set`` restricts the timesteps to its
    entries."""
    B = shape[0]
    if timestep_set is None:
        timesteps = torch.randint(0, ddpm.num_train_timesteps, (B,), generator=generator,
                                  device=device)
    else:
        timesteps = timestep_set[torch.randint(0, timestep_set.shape[0], (B,),
                                               generator=generator, device=device)]
    return timesteps, torch.randn(shape, generator=generator, device=device)


def loss_fn(model: DenoiserTransformer, encoder: FrozenEncoder, ddpm: DDPMParams, batch: dict,
            generator: torch.Generator | None = None, timestep_set: torch.Tensor | None = None,
            encode_cached: bool = False, timesteps: torch.Tensor | None = None,
            noise: torch.Tensor | None = None, group=None):
    """-> (this rank's share of the mse, the global batch's metrics). ``timesteps`` [B] and
    ``noise`` [B, P, 7] are drawn from ``generator`` unless given (the trainer draws them for
    the global batch, tests inject the JAX package's draws); ``timestep_set`` restricts the
    drawn timesteps to its entries. ``group``: the ranks that split the batch (all)."""
    gt = _gt(batch)
    ref = batch["ref_part"].bool()
    if timesteps is None or noise is None:
        drawn = draw_step_noise(ddpm, gt.shape, generator, timestep_set, gt.device)
        timesteps = drawn[0] if timesteps is None else timesteps
        noise = drawn[1] if noise is None else noise
    noisy = torch.where(ref[..., None], gt, add_noise(ddpm, gt, noise, timesteps))
    # the encoder is frozen (the JAX package's stop_gradient)
    with torch.no_grad(), profiling.span("pfpp.train.encode"):
        cache = (build_feature_cache(encoder, batch["part_pcs"], batch["part_valids"])
                 if encode_cached else None)
        latent, xyz = extract_features(encoder, batch["part_pcs"], noisy, cache,
                                       batch["part_valids"])
    pred = model(noisy, timesteps, latent, xyz, batch["part_valids"], batch["part_scale"], ref)
    w = ((batch["part_valids"] > 0) & ~ref)[..., None].to(pred.dtype)
    # F.mse_loss over the selected [M, 7] elements == weighted sum / (M * 7), M global
    mse = ((pred - noise) ** 2 * w).sum() / (mesh.global_sum(w.sum(), group) * 7.0).clamp_min(1.0)
    return mse, mesh.global_sums({"mse_loss": mse.detach()}, group)


def train_step(state: TrainState, batch: dict, encoder: FrozenEncoder, ddpm: DDPMParams,
               generator: torch.Generator | None = None, timestep_set=None,
               encode_cached: bool = False, timesteps=None, noise=None) -> dict:
    """One AdamW update on ``batch`` (this rank's rows, tensors on the model's device) with
    the gradient summed over the ranks; returns the global batch's metrics."""
    with profiling.span("pfpp.train.step", request=True):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.model, encoder, ddpm, batch, generator, timestep_set,
                                encode_cached, timesteps, noise)
        loss.backward()
        mesh.all_reduce_gradients(state.model)
        with profiling.span("pfpp.train.optimizer"):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
    return metrics


def make_sample_fn(model: DenoiserTransformer, encoder: FrozenEncoder, ddpm: DDPMParams,
                   num_inference_steps: int):
    """The validation sampler: noise -> 20-step reverse loop -> (final [B, P, 7],
    trajectory [S, B, P, 7]). The grouping cache is built once per batch (rotation leaves
    it unchanged). ``init`` / ``noise_seq`` replace the draws from ``generator``."""
    timesteps = leading_timesteps(ddpm.num_train_timesteps, num_inference_steps).tolist()

    @torch.no_grad()
    def sample(batch: dict, generator: torch.Generator | None = None,
               init: torch.Tensor | None = None, noise_seq: torch.Tensor | None = None):
        model.eval()
        gt = _gt(batch)
        ref = batch["ref_part"].bool()
        reference_vals = torch.where(ref[..., None], gt, torch.zeros_like(gt))
        if init is None:
            init = torch.randn(gt.shape, generator=generator, device=gt.device)
        cache = build_feature_cache(encoder, batch["part_pcs"], batch["part_valids"])

        def denoise_fn(noisy, t):
            latent, xyz = extract_features(encoder, batch["part_pcs"], noisy, cache)
            return model(noisy, t, latent, xyz, batch["part_valids"], batch["part_scale"], ref)

        return ddpm_sample(denoise_fn, ddpm, timesteps, init, ref, reference_vals, generator,
                           num_inference_steps, noise_seq)

    return sample


def eval_metrics(final: torch.Tensor, batch: dict) -> dict:
    """Per-shape [B] ``EVAL_KEYS`` of the sampler's final poses against the GT."""
    pts = batch["part_pcs"] * batch["part_scale"][..., None]  # world units
    m = assembly_metrics(pts, final[..., :3], final[..., 3:], batch["part_trans"],
                         batch["part_rots"], batch["part_valids"], batch["ref_part"])
    return {k: m[k] for k in EVAL_KEYS}


def load_frozen_encoder(cfg: Config, device) -> FrozenEncoder:
    """The stage-1 VQ-VAE from ``denoiser.encoder_ckpt_path`` (a ``training.vqvae``
    checkpoint: a ``step_N`` dir, a ckpt dir for its best, or ``.../best`` / ``.../latest``;
    or an original-repo Lightning file, ``training/state.py::load_model_state``), or
    untrained from seed 0 when no path is given. Under ``trainer.precision=bf16`` it
    computes in bf16 (``VQVAE.with_dtype``: the composable encode; kernels S and R keep
    their fp32 folded weights, as the JAX package's fused encodes do)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        ae = make_ae_model(cfg).with_dtype(compute_dtype(cfg))
    if cfg.denoiser.encoder_ckpt_path:
        ae.load_state_dict(load_model_state(cfg.denoiser.encoder_ckpt_path, "vqvae"))
    return make_frozen_encoder(ae.to(device))


def _setup(cfg: Config, device):
    """-> (train loader, val loader, prepare, state at its seeded init)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.trainer.seed)
        model = make_model(cfg).to(device)
    kw = dict(max_num_part=cfg.data.max_num_part,
              multiple_ref_parts=cfg.denoiser.multiple_ref_parts, overfit=cfg.data.overfit)
    train_ds = DenoiserDataset(cfg.data.data_dir, mode="train", **kw)
    val_ds = DenoiserDataset(cfg.data.data_val_dir, mode="val", **kw)
    # part-count bucketing: batches never mix buckets and each is sliced to its bucket's
    # pad (from the global batch, so every rank runs the same shapes); the loss masks the
    # pad, so training does not depend on it
    mult, cap = cfg.data.part_bucket_multiple, cfg.data.max_num_part

    def bucket_key(ds):
        return [part_bucket(int(c), mult, cap=cap) for c in ds.num_parts_list()] if mult else None

    def prepare(batch, pad=False):
        if mult:
            batch = slice_batch_parts(
                batch, part_bucket(int(np.max(batch["num_parts"])), mult, cap=cap))
        return local_rows(batch, device, pad)

    train_loader = Loader(train_ds, cfg.data.batch_size, seed=cfg.trainer.seed,
                          bucket_key=bucket_key(train_ds))
    val_loader = Loader(val_ds, cfg.data.val_batch_size, shuffle=False, drop_last=False,
                        seed=cfg.trainer.seed, bucket_key=bucket_key(val_ds))
    d = cfg.denoiser
    return train_loader, val_loader, prepare, adamw_reference(model, d.lr, d.b1, d.b2,
                                                              d.weight_decay)


def _global_draws(shape, generator: torch.Generator, steps: int):
    """The validation sampler's draws for the global batch: (init [B, P, 7], per-step
    noise [steps, B, P, 7]), in the order the sampler itself draws them."""
    init = torch.randn(shape, generator=generator, device=generator.device)
    seq = [torch.randn(shape, generator=generator, device=generator.device)
           for _ in range(steps)]
    return init, torch.stack(seq)


def train(cfg: Config, max_steps: int | None = None, device=None,
          join_timeout_s: float | None = None) -> TrainState:
    """Train from a seeded init (or resume), validating every ``denoiser.val_every`` epochs
    and keeping the top-k checkpoints by eval part accuracy; ``max_steps`` stops early with
    a checkpoint. Runs on ``cuda`` unless ``device="cpu"``, in ``trainer.precision``
    (``models/denoiser.py::compute_dtype``), on ``trainer.num_devices``
    (``training.vqvae.train`` says how); a producer thread builds the next batch meanwhile."""
    device = resolve_device(device)
    out_dir = f"{cfg.trainer.output_dir}/{cfg.trainer.experiment_name}/denoiser"
    spawned = launch.entry(launch.discard_result, (train, cfg, max_steps, device),
                           cfg.trainer.num_devices, device, cfg.data.batch_size, join_timeout_s)
    if spawned is not launch.HERE:
        return maybe_restore(_setup(cfg, device)[3], f"{out_dir}/ckpt")
    train_loader, val_loader, prepare, state = _setup(cfg, device)
    mesh.seed_ranks(cfg.trainer.seed)  # the ranks' dropout masks differ
    encoder = load_frozen_encoder(cfg, device)
    ddpm = DDPMParams.piecewise(cfg.denoiser.ddpm_train_steps)
    d = cfg.denoiser
    sample_fn = make_sample_fn(state.model, encoder, ddpm, d.num_inference_steps)
    timestep_set = (
        torch.as_tensor(leading_timesteps(d.ddpm_train_steps, d.num_inference_steps),
                        device=device)
        if d.train_on_inference_timesteps else None
    )
    generator = torch.Generator(device=device).manual_seed(cfg.trainer.seed)

    logger = MetricsLogger(out_dir)
    # top-3 on eval part accuracy (reference config/denoiser/global_config.yaml:42-50)
    topk = TopKCheckpointer(f"{out_dir}/ckpt", monitor="eval_part_acc", mode="max",
                            top_k=cfg.trainer.ckpt_top_k, smooth_k=cfg.trainer.ckpt_smooth_k)
    state = maybe_restore(state, f"{out_dir}/ckpt", d.ckpt_path)
    mesh.replicate(state.model)
    rank, world = mesh.rank(), mesh.world()
    steps_per_epoch = max(len(train_loader), 1)
    for epoch in range(min(state.step // steps_per_epoch, d.epochs), d.epochs):
        for batch in prefetch_batches(train_loader):
            step = state.step
            local = prepare(batch)
            b, P = local["part_valids"].shape
            t, noise = draw_step_noise(ddpm, (b * world, P, 7), generator, timestep_set,
                                       device)
            rows = slice(rank * b, (rank + 1) * b)
            metrics = train_step(state, local, encoder, ddpm, encode_cached=d.train_encode_cached,
                                 timesteps=t[rows], noise=noise[rows])
            if step % cfg.trainer.log_every == 0:
                logger.log(step, epoch=epoch, **metrics)
            if max_steps is not None and state.step >= max_steps:
                save_checkpoint(f"{out_dir}/ckpt", state)
                return state
        if (epoch + 1) % d.val_every == 0 or epoch + 1 == d.epochs:
            evals = []
            for batch in val_loader:
                # the padded global batch, repeats included, as the JAX trainer computes it
                local = prepare(batch, pad=True)
                b, P = local["part_valids"].shape
                init, seq = _global_draws((b * world, P, 7), generator, d.num_inference_steps)
                rows = slice(rank * b, (rank + 1) * b)
                final, _ = sample_fn(local, init=init[rows], noise_seq=seq[:, rows])
                sums = {k: v.float().sum() for k, v in eval_metrics(final, local).items()}
                sums = mesh.global_sums({**sums, "count": torch.tensor(float(b), device=device)})
                evals.append({k: float(sums[k] / sums["count"]) for k in EVAL_KEYS})
            if evals:
                agg = {k: float(np.mean([e[k] for e in evals])) for k in EVAL_KEYS}
                logger.log(state.step, epoch=epoch, **{f"eval_{k}": v for k, v in agg.items()})
                topk.save(state, state.step, agg["part_acc"])
            else:
                save_checkpoint(f"{out_dir}/ckpt", state)
    return state


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    train(config_from_argv(argv), device="cpu" if "--cpu" in argv else None)


if __name__ == "__main__":
    main()
