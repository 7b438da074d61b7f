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

from puzzlefusion_plusplus_tpu_torch.data.bucketing import bucketed_loaders
from puzzlefusion_plusplus_tpu_torch.data.datasets import VQVAEDataset
from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device
from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE
from puzzlefusion_plusplus_tpu_torch.ops.chamfer import nn_distance
from puzzlefusion_plusplus_tpu_torch.parallel import mesh
from puzzlefusion_plusplus_tpu_torch.training import loop
from puzzlefusion_plusplus_tpu_torch.training.state import TrainState, adamw_multistep
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
    # part-count bucketing: compute follows the compacted slot count B*P, and slot masking
    # keeps the loss and the BatchNorm statistics independent of the pad
    d = cfg.data
    train_loader, val_loader, prepare = bucketed_loaders(
        VQVAEDataset(d.data_dir, d.max_num_part, d.min_num_part, d.overfit),
        VQVAEDataset(d.data_val_dir, d.max_num_part, d.min_num_part, d.overfit), d,
        cfg.trainer.seed, lambda batch, pad: local_rows(batch, device, pad))
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
    """Train through ``training/loop.py``, validating every ``trainer.ckpt_every_epochs``
    and keeping the top-k checkpoints by val cd_loss. Runs on ``cuda`` unless
    ``device="cpu"``, on ``trainer.num_devices`` (``parallel/mesh.py::world_size``; above
    one, ``loop.spawned`` says what comes back)."""
    device = resolve_device(device)
    out_dir = f"{cfg.trainer.output_dir}/{cfg.trainer.experiment_name}/vqvae"
    done = loop.spawned(out_dir, lambda: _setup(cfg, device)[3], train, (cfg, max_steps, device),
                        cfg.trainer.num_devices, device, cfg.data.batch_size, join_timeout_s)
    if done is not None:
        return done
    train_loader, val_loader, prepare, state = _setup(cfg, device)

    def validate():
        vals = [float(eval_step(state, prepare(b, pad=True))["cd_loss"]) for b in val_loader]
        if not vals:
            return None
        val_cd = float(np.mean(vals))
        return {"val_cd_loss": val_cd}, val_cd

    # top-k on val cd_loss, mode min (reference config/ae/global_config.yaml:42-50)
    topk = dict(monitor="val_cd_loss", mode="min", top_k=cfg.trainer.ckpt_top_k)
    return loop.fit(state, out_dir, train_loader, cfg.ae.epochs,
                    lambda epoch, batch: train_step(state, prepare(batch)), validate, topk,
                    cfg.trainer.ckpt_every_epochs, cfg.trainer.log_every, max_steps,
                    cfg.ae.ckpt_path)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    train(config_from_argv(argv), device="cpu" if "--cpu" in argv else None)


if __name__ == "__main__":
    main()
