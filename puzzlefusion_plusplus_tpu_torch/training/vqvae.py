"""Stage-1 VQ-VAE training (port of ``puzzlefusion_plusplus_tpu/training/vqvae.py``).

``python -m puzzlefusion_plusplus_tpu_torch.training.vqvae data.data_dir=...
data.data_val_dir=...`` trains on the GPU (``--cpu`` for the CPU), with the JAX package's
config keys. The loss is the reference FractureAE's: bidirectional chamfer between the
reconstruction and the input part cloud with chamferdist's default reductions (per-part
point sum, mean over the valid parts), plus the quantizer's embedding loss, both masked over
the compacted valid part slots.

``trainer.num_devices`` above 1 trains data-parallel (``parallel/``): the entry spawns one
process a card (NCCL; gloo on the CPU), every rank builds the same global batch of
``data.batch_size`` shapes and keeps its rows, and the losses, the BatchNorm statistics and
the perplexity are those of the global batch, so a step equals the one-process step on the
same batch. Rank 0 writes the checkpoints and the log.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.data.bucketing import part_bucket, slice_batch_parts
from puzzlefusion_plusplus_tpu_torch.data.datasets import VQVAEDataset
from puzzlefusion_plusplus_tpu_torch.data.loader import Loader, prefetch_batches
from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE
from puzzlefusion_plusplus_tpu_torch.ops.chamfer import nn_distance
from puzzlefusion_plusplus_tpu_torch.parallel import launch, mesh
from puzzlefusion_plusplus_tpu_torch.training.state import (
    MetricsLogger,
    TopKCheckpointer,
    TrainState,
    adamw_multistep,
    maybe_restore,
    save_checkpoint,
)
from puzzlefusion_plusplus_tpu_torch.utils.config import Config, config_from_argv
from puzzlefusion_plusplus_tpu_torch.utils.masking import compact_parts, compaction_indices

METRIC_KEYS = ("cd_loss", "embedding_loss", "perplexity", "total_loss")
SHARES = ("cd_loss", "embedding_loss", "total_loss", "valid_parts")  # summed over the ranks


def make_model(cfg: Config) -> VQVAE:
    return VQVAE(cfg.ae.n_embeddings, cfg.ae.embedding_dim, cfg.ae.num_point, cfg.ae.num_dim,
                 cfg.ae.local_decode_pts, beta=cfg.ae.beta)


def _flatten_compact(batch: dict):
    """part_pcs [B, P, N, 3] -> compacted [B*P, N, 3] and slot mask [B*P] bool."""
    pcs, valids = batch["part_pcs"], batch["part_valids"]
    B, P, N, _ = pcs.shape
    _, src, slot_valid = compaction_indices(valids)
    return compact_parts(pcs, src).reshape(B * P, N, 3), slot_valid.reshape(B * P)


def loss_fn(model: VQVAE, batch: dict):
    """-> (this rank's share of the total loss, the global batch's metrics); BatchNorm runs
    in train mode when ``model.training``. ``valid_parts`` counts the batch's real parts
    (the slots the loss averages over). On one process the share is the loss."""
    flat, slot_mask = _flatten_compact(batch)
    w = slot_mask.to(flat.dtype)
    out = model(flat, mask=w)
    recon = model.reconstruction(out)
    per_part_cd = nn_distance(recon, flat)[0].sum(-1) + nn_distance(flat, recon)[0].sum(-1)
    cd_loss = (per_part_cd * w).sum() / mesh.global_sum(w.sum()).clamp_min(1.0)
    total = cd_loss + out["embedding_loss"]
    metrics = {"cd_loss": cd_loss, "embedding_loss": out["embedding_loss"],
               "perplexity": out["perplexity"], "total_loss": total, "valid_parts": w.sum()}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total, {**metrics, **mesh.global_sums({k: metrics[k] for k in SHARES})}


def to_device(batch: dict, device) -> dict:
    """The numeric arrays of a loader batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray) and v.dtype != object}


def local_rows(batch: dict, device, pad: bool = False) -> dict:
    """This rank's rows of a global loader batch, as ``to_device`` gives them; ``pad``
    first pads a ragged batch to a multiple of the world size by repeating row 0, as the
    JAX trainers' validation does (the repeats count in the metrics there too)."""
    batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray) and v.dtype != object}
    if pad:
        batch = mesh.pad_batch_to_devices(batch, mesh.world())[0]
    return to_device(mesh.shard_batch(batch, mesh.rank(), mesh.world()), device)


def train_step(state: TrainState, batch: dict) -> dict:
    """One AdamW update on ``batch`` (this rank's rows, tensors on the model's device) with
    the gradient summed over the ranks; returns the global batch's metrics."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(state.model, batch)
    loss.backward()
    mesh.all_reduce_gradients(state.model)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return metrics


@torch.no_grad()
def eval_step(state: TrainState, batch: dict) -> dict:
    state.model.eval()
    return loss_fn(state.model, batch)[1]


def _setup(cfg: Config, device):
    """-> (train loader, val loader, prepare, state at its seeded init)."""
    train_ds = VQVAEDataset(cfg.data.data_dir, cfg.data.max_num_part, cfg.data.min_num_part,
                            cfg.data.overfit)
    val_ds = VQVAEDataset(cfg.data.data_val_dir, cfg.data.max_num_part,
                          cfg.data.min_num_part, cfg.data.overfit)
    # part-count bucketing: compute follows the compacted slot count B*P, and slot masking
    # keeps the loss and the BatchNorm statistics independent of the pad
    mult, cap = cfg.data.part_bucket_multiple, cfg.data.max_num_part

    def bucket_key(ds):
        return [part_bucket(int(c), mult, cap=cap) for c in ds.num_parts_list()] if mult else None

    def prepare(batch, pad=False):
        # the pad comes from the global batch, so every rank runs the same shapes
        if mult:
            batch = slice_batch_parts(
                batch, part_bucket(int(np.max(batch["num_parts"])), mult, cap=cap))
        return local_rows(batch, device, pad)

    train_loader = Loader(train_ds, cfg.data.batch_size, seed=cfg.trainer.seed,
                          bucket_key=bucket_key(train_ds))
    val_loader = Loader(val_ds, cfg.data.val_batch_size, shuffle=False, drop_last=False,
                        seed=cfg.trainer.seed, bucket_key=bucket_key(val_ds))
    steps_per_epoch = max(len(train_loader), 1)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.trainer.seed)
        model = make_model(cfg).to(device).reduce_over(mesh.data_group())
    state = adamw_multistep(model, cfg.ae.lr,
                            [int(m) * steps_per_epoch for m in cfg.ae.lr_milestones],
                            cfg.ae.lr_gamma, cfg.ae.weight_decay)
    return train_loader, val_loader, prepare, state


def train(cfg: Config, max_steps: int | None = None, device=None,
          join_timeout_s: float | None = None) -> TrainState:
    """Train from a seeded init (or resume), validating and keeping the top-k checkpoints
    by val cd_loss every ``trainer.ckpt_every_epochs``; ``max_steps`` stops early with a
    checkpoint. Runs on ``cuda`` unless ``device="cpu"``, on ``trainer.num_devices``
    (``parallel/mesh.py::world_size``): above one it spawns the ranks
    (``parallel/launch.py::entry``; ``join_timeout_s`` bounds their run) and returns the
    state of the last checkpoint they wrote. A producer thread builds the next batch
    meanwhile."""
    device = resolve_device(device)
    out_dir = f"{cfg.trainer.output_dir}/{cfg.trainer.experiment_name}/vqvae"
    spawned = launch.entry(launch.discard_result, (train, cfg, max_steps, device),
                           cfg.trainer.num_devices, device, cfg.data.batch_size, join_timeout_s)
    if spawned is not launch.HERE:
        return maybe_restore(_setup(cfg, device)[3], f"{out_dir}/ckpt")
    train_loader, val_loader, prepare, state = _setup(cfg, device)
    steps_per_epoch = max(len(train_loader), 1)
    logger = MetricsLogger(out_dir)
    # top-k on val cd_loss, mode min (reference config/ae/global_config.yaml:42-50)
    topk = TopKCheckpointer(f"{out_dir}/ckpt", monitor="val_cd_loss", mode="min",
                            top_k=cfg.trainer.ckpt_top_k)
    state = maybe_restore(state, f"{out_dir}/ckpt", cfg.ae.ckpt_path)
    mesh.replicate(state.model)
    start_epoch = min(state.step // steps_per_epoch, cfg.ae.epochs)
    for epoch in range(start_epoch, cfg.ae.epochs):
        for batch in prefetch_batches(train_loader):
            step = state.step
            metrics = train_step(state, prepare(batch))
            if step % cfg.trainer.log_every == 0:
                logger.log(step, epoch=epoch, **metrics)
            if max_steps is not None and state.step >= max_steps:
                save_checkpoint(f"{out_dir}/ckpt", state)
                return state
        if (epoch + 1) % cfg.trainer.ckpt_every_epochs == 0 or epoch + 1 == cfg.ae.epochs:
            vals = [float(eval_step(state, prepare(b, pad=True))["cd_loss"])
                    for b in val_loader]
            if vals:
                val_cd = float(np.mean(vals))
                logger.log(state.step, epoch=epoch, val_cd_loss=val_cd)
                topk.save(state, state.step, val_cd)
            else:
                save_checkpoint(f"{out_dir}/ckpt", state)
    return state


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    train(config_from_argv(argv), device="cpu" if "--cpu" in argv else None)


if __name__ == "__main__":
    main()
