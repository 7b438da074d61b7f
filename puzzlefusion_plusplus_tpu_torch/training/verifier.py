"""Stage-3 verifier training (port of ``puzzlefusion_plusplus_tpu/training/verifier.py``).

``python -m puzzlefusion_plusplus_tpu_torch.training.verifier data.verifier_data_path=...``
trains on the GPU (``--cpu`` for the CPU), with the JAX package's config keys. Semantics
(reference verifier/model/verifier.py):

* loss: BCE-with-logits over the valid edges with weight ``verifier.negative_weight`` (0.2)
  on the negatives, normalised by the valid-edge count; accuracy, precision, recall and F1
  with torchmetrics' binary semantics, masked to the valid edges.
* optimizer: AdamW lr 2e-4, betas (0.95, 0.999), weight decay 1e-6, no schedule.
* data: the verifier files split 80/20 into train and val (``VerifierDataset``); top-k
  checkpoints on ``val_cls_acc`` (mode max), validation every ``trainer.ckpt_every_epochs``
  and at the last epoch; auto-resume from ``verifier.ckpt_path`` or the latest checkpoint.

In fp32 under any ``trainer.precision``: the JAX verifier trainer reads no precision key.
``trainer.num_devices`` above 1
trains data-parallel (``parallel/``, as ``training.vqvae``): the loss is normalised by the
global count of valid edges, and accuracy, precision, recall and F1 come from the ranks'
summed tp/fp/fn/tn counts.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.data.datasets import VerifierDataset
from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device
from puzzlefusion_plusplus_tpu_torch.models.verifier import VerifierTransformer
from puzzlefusion_plusplus_tpu_torch.parallel import mesh
from puzzlefusion_plusplus_tpu_torch.training import loop
from puzzlefusion_plusplus_tpu_torch.training.state import TrainState, adamw_reference
from puzzlefusion_plusplus_tpu_torch.training.vqvae import local_rows
from puzzlefusion_plusplus_tpu_torch.utils.config import Config, config_from_argv

METRIC_KEYS = ("cls_loss", "cls_acc", "cls_precision", "cls_recall", "cls_f1_score")


def make_model(cfg: Config, dropout: float = 0.1) -> VerifierTransformer:
    v = cfg.verifier
    return VerifierTransformer(v.embed_dim, v.num_layers, v.num_heads, v.max_nodes,
                               v.num_features, dropout=dropout)


def binary_cls_metrics(pred: torch.Tensor, gt: torch.Tensor, w: torch.Tensor,
                       reduce: bool = True) -> dict:
    """Masked accuracy / precision / recall / F1 (torchmetrics' 'binary' semantics) of the
    global batch: the ratios of the ranks' summed counts (of this process's batch alone
    without ``reduce``, as for a batch every rank holds whole)."""
    c = {"tp": (w * pred * gt).sum(), "fp": (w * pred * (1 - gt)).sum(),
         "fn": (w * (1 - pred) * gt).sum(), "tn": (w * (1 - pred) * (1 - gt)).sum(),
         "n": w.sum()}
    if reduce:
        c = mesh.global_sums(c)
    tp, fp, fn, tn = c["tp"], c["fp"], c["fn"], c["tn"]
    eps = 1e-9
    precision = tp / (tp + fp).clamp_min(eps)
    recall = tp / (tp + fn).clamp_min(eps)
    return {
        "cls_acc": (tp + tn) / c["n"].clamp_min(eps),
        "cls_precision": precision,
        "cls_recall": recall,
        "cls_f1_score": 2 * precision * recall / (precision + recall).clamp_min(eps),
    }


def loss_fn(model: VerifierTransformer, batch: dict, negative_weight: float):
    """-> (this rank's share of the loss, the global batch's metrics); dropout acts when
    ``model.training``."""
    logits = model(batch["edge_features"], batch["edge_indices"],
                   batch["edge_valids"])[..., 0]  # [B, E]
    gt, valid = batch["cls_gt"], batch["edge_valids"]
    # weighted BCE-with-logits in the JAX package's form, `negative_weight` on negatives
    per_edge = logits.clamp_min(0) - logits * gt + torch.log1p(torch.exp(-logits.abs()))
    cls_w = torch.where(gt == 0, negative_weight, 1.0) * valid
    cls_loss = (per_edge * cls_w).sum() / mesh.global_sum(valid.sum()).clamp_min(1.0)
    pred = (torch.sigmoid(logits) > 0.5).to(gt.dtype)
    metrics = {**mesh.global_sums({"cls_loss": cls_loss.detach()}),
               **binary_cls_metrics(pred, gt, valid)}
    return cls_loss, {k: v.detach() for k, v in metrics.items()}


def train_step(state: TrainState, batch: dict, negative_weight: float) -> dict:
    """One AdamW update on ``batch`` (this rank's rows, tensors on the model's device) with
    the gradient summed over the ranks; returns the global batch's metrics."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(state.model, batch, negative_weight)
    loss.backward()
    mesh.all_reduce_gradients(state.model)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return metrics


@torch.no_grad()
def eval_step(state: TrainState, batch: dict, negative_weight: float) -> dict:
    state.model.eval()
    return loss_fn(state.model, batch, negative_weight)[1]


def _setup(cfg: Config, device):
    """-> (train loader, val loader, state at its seeded init)."""
    train_ds = VerifierDataset(cfg.data.verifier_data_path, "train", cfg.data.overfit)
    val_ds = VerifierDataset(cfg.data.verifier_data_path, "val", cfg.data.overfit)
    train_loader = Loader(train_ds, cfg.data.batch_size, seed=cfg.trainer.seed)
    val_loader = Loader(val_ds, cfg.data.val_batch_size, shuffle=False, drop_last=False,
                        seed=cfg.trainer.seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.trainer.seed)
        model = make_model(cfg).to(device)
    v = cfg.verifier
    return train_loader, val_loader, adamw_reference(model, v.lr, v.b1, v.b2, v.weight_decay)


def train(cfg: Config, max_steps: int | None = None, device=None,
          join_timeout_s: float | None = None) -> TrainState:
    """Train through ``training/loop.py``, keeping the top-k checkpoints by val cls_acc.
    Runs on ``cuda`` unless ``device="cpu"``, on ``trainer.num_devices`` (as
    ``training.vqvae.train``)."""
    device = resolve_device(device)
    out_dir = f"{cfg.trainer.output_dir}/{cfg.trainer.experiment_name}/verifier"
    done = loop.spawned(out_dir, lambda: _setup(cfg, device)[2], train, (cfg, max_steps, device),
                        cfg.trainer.num_devices, device, cfg.data.batch_size, join_timeout_s)
    if done is not None:
        return done
    train_loader, val_loader, state = _setup(cfg, device)
    mesh.seed_ranks(cfg.trainer.seed)  # the ranks' dropout masks differ
    v = cfg.verifier

    def validate():
        # the padded global batch, repeats included, as the JAX trainer computes it
        vals = [{k: float(x) for k, x in eval_step(state, local_rows(b, device, pad=True),
                                                   v.negative_weight).items()}
                for b in val_loader]
        if not vals:
            return None
        agg = {f"val_{k}": float(np.mean([r[k] for r in vals])) for k in METRIC_KEYS}
        return agg, agg["val_cls_acc"]

    # top-k on val cls_acc (reference config/verifier/global_config.yaml:41-49)
    topk = dict(monitor="val_cls_acc", mode="max", top_k=cfg.trainer.ckpt_top_k)
    return loop.fit(state, out_dir, train_loader, v.epochs,
                    lambda epoch, batch: train_step(state, local_rows(batch, device),
                                                    v.negative_weight),
                    validate, topk, cfg.trainer.ckpt_every_epochs, cfg.trainer.log_every,
                    max_steps, v.ckpt_path)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    train(config_from_argv(argv), device="cpu" if "--cpu" in argv else None)


if __name__ == "__main__":
    main()
