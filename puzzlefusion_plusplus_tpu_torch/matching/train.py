"""Matcher training (port of ``puzzlefusion_plusplus_tpu/matching/train.py``).

``python -m puzzlefusion_plusplus_tpu_torch.matching.train data_dir=... [val_data_dir=...]
[num_devices=N] [--cpu]`` trains on the GPU with the JAX entry's keys. Semantics (the
reference Jigsaw's train_matching.py and model_config.py:27-31):

* loss: BCE on the fracture-point logits (``cls_pos_weight`` on the positives; NLL for
  ``cls_method='multi'``), plus the permutation loss from epoch ``mat_epoch`` and the rigid
  loss from epoch ``rig_epoch``. The stage is a Python-level gate set per epoch: before
  ``rig_epoch`` the rigid loss is not computed at all.
* optimizer: Adam under a cosine decay over ``epochs`` x steps an epoch
  (``training/state.py::adam_cosine``).
* validation every ``val_every`` epochs and at the last: the losses and the Hungarian
  matching F1 (``eval_step``), top-k checkpoints on ``mat_f1``; auto-resume from the latest.

Spans (``utils/profiling.py``): ``pfpp.match.step`` around ``train_step`` (a request id a
step), ``pfpp.match.loss`` around ``loss_fn`` (the labels, the GT permutation and the losses;
the forward's spans, ``matching/model.py``, open inside it), ``pfpp.match.backward``,
``pfpp.match.optimizer`` (Adam and the scheduler), and ``pfpp.sync.match_batch`` around each
array's blocking copy to the card (``device_batch``).

``num_devices`` above 1 trains data-parallel on the port's mesh (``parallel/``): every rank
builds the same global batch and keeps its rows; the losses are local sums over global
counts, the BatchNorm statistics are the global batch's (``JigsawModel.reduce_over``), the
binary metrics come from summed counts and the gradients are summed, so a step equals the
one-process step. Validation batches are held whole by every rank, as the JAX trainer
replicates them.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device
from puzzlefusion_plusplus_tpu_torch.matching import ops as mops
from puzzlefusion_plusplus_tpu_torch.matching.dataset import AllPieceMatchingDataset
from puzzlefusion_plusplus_tpu_torch.matching.model import (
    JigsawModel,
    global_count,
    gt_permutation,
    hungarian_perm,
    permutation_loss,
    rigid_loss_pairs,
)
from puzzlefusion_plusplus_tpu_torch.parallel import mesh
from puzzlefusion_plusplus_tpu_torch.training import loop
from puzzlefusion_plusplus_tpu_torch.training.state import TrainState, adam_cosine
from puzzlefusion_plusplus_tpu_torch.training.verifier import binary_cls_metrics
from puzzlefusion_plusplus_tpu_torch.training.vqvae import local_rows, to_device
from puzzlefusion_plusplus_tpu_torch.utils import profiling

LOSS_KEYS = ("cls_loss", "mat_loss", "rig_loss", "loss")
METRIC_KEYS = LOSS_KEYS + ("cls_acc", "cls_precision", "cls_recall", "cls_f1_score")


def make_model(pc_feat_dim=128, aff_feat_dim=512, encoder="pointnet2",
               sa_npoints=(1024, 256, 64, 16), cls_method="binary", num_classes=2,
               canonicalize=False, max_num_part=20) -> JigsawModel:
    return JigsawModel(pc_feat_dim=pc_feat_dim, aff_feat_dim=aff_feat_dim,
                       encoder_type=encoder, sa_npoints=sa_npoints, cls_method=cls_method,
                       num_classes=num_classes, canonicalize_inputs=canonicalize,
                       max_num_part=max_num_part)


def loss_fn(model: JigsawModel, batch: dict, w_mat: float, w_rig: float,
            cls_pos_weight: float = 1.0, group=None):
    """-> (this rank's share of the loss, the metrics of ``group``'s batch, the forward's
    outputs, the GT permutation, the cross-piece mask). ``group``: the ranks whose global
    batch the counts cover (None: this process's batch)."""
    with profiling.span("pfpp.match.loss"):
        pid = batch["piece_id"]
        n_valid = batch["part_valids"].sum(-1).to(torch.int32)
        labels = mops.fracture_point_labels(batch["gt_pcs"], pid, n_valid,
                                            batch["critical_label_thresholds"])
        out = model(batch["part_pcs"], pid, n_valid, labels, compute_matching=True)
        w = mops.valid_point_mask(pid, n_valid).float()
        logits, gt = out["cls_logits"], labels.float()
        if model.cls_method == "binary":
            bce = logits.clamp_min(0) - logits * gt + torch.log1p(torch.exp(-logits.abs()))
            wc = w * torch.where(gt > 0, float(cls_pos_weight), 1.0)
            cls_loss = (bce * wc).sum() / global_count(wc.sum(), group).clamp_min(1.0)
        else:  # NLL over the log-softmax logits
            nll = -torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
            cls_loss = (nll * w).sum() / global_count(w.sum(), group).clamp_min(1.0)

        slot_valid, order, cross = out["crit_slot_valid"], out["crit_order"], out["s_mask"]
        gt_crit = torch.take_along_dim(batch["gt_pcs"], order[..., None], dim=1)
        gt_perm = gt_permutation(torch.where(slot_valid[..., None], gt_crit, 1e3), cross)
        mat_loss = permutation_loss(out["ds_mat"], gt_perm, out["n_critical_sum"], group)
        if w_rig > 0:  # a Python-level gate: before rig_epoch the rigid loss does not run
            pts_crit = torch.take_along_dim(batch["part_pcs"], order[..., None], dim=1)
            rig_loss = rigid_loss_pairs(out["ds_mat"], pts_crit, out["crit_pid"], slot_valid,
                                        batch["part_valids"].shape[-1], group)
        else:
            rig_loss = torch.zeros((), device=logits.device)
        total = cls_loss + w_mat * mat_loss + w_rig * rig_loss
        shares = {"cls_loss": cls_loss, "mat_loss": mat_loss, "rig_loss": rig_loss, "loss": total}
        shares = {k: v.detach() for k, v in shares.items()}
        metrics = {**(shares if group is None else mesh.global_sums(shares, group)),
                   **binary_cls_metrics(out["cls_pred"].float(), gt, w, reduce=group is not None)}
        return total, metrics, out, gt_perm, cross


def train_step(state: TrainState, batch: dict, w_mat: float, w_rig: float,
               cls_pos_weight: float = 1.0) -> dict:
    """One Adam update on ``batch`` (this rank's rows, tensors on the model's device) with
    the gradient summed over the ranks; returns the global batch's metrics."""
    with profiling.span("pfpp.match.step", request=True):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics, *_ = loss_fn(state.model, batch, w_mat, w_rig, cls_pos_weight,
                                    mesh.data_group())
        with profiling.span("pfpp.match.backward"):
            loss.backward()
        mesh.all_reduce_gradients(state.model)
        with profiling.span("pfpp.match.optimizer"):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
    return metrics


def device_batch(batch: dict, device) -> dict:
    """This rank's rows of a loader batch on ``device``, as ``local_rows`` gives them; each
    array's copy blocks the host (span ``pfpp.sync.match_batch``, one an array)."""
    out = {}
    for k, v in local_rows(batch, "cpu").items():
        with profiling.span("pfpp.sync.match_batch"):
            out[k] = v.to(device)
    return out


@torch.no_grad()
def eval_step(model: JigsawModel, batch: dict) -> dict:
    """Validation metrics of a batch this process holds whole, with the Hungarian-
    discretised matching precision, recall and F1 computed on the host (the reference's
    val/mat_f1 monitor)."""
    model.eval()
    _, metrics, out, gt_perm, cross = loss_fn(model, batch, 1.0, 0.0)
    n_crit = out["n_critical_sum"].cpu().numpy()
    perm = hungarian_perm(out["ds_mat"].cpu().numpy(), n_crit)
    gt_perm, cross = gt_perm.cpu().numpy(), cross.cpu().numpy()
    tp = float((perm * gt_perm * cross).sum())
    fp = float((perm * (1.0 - gt_perm) * cross).sum())
    fn = float(((1.0 - perm) * gt_perm * cross).sum())
    eps = 1e-7
    precision, recall = tp / (tp + fp + eps), tp / (tp + fn + eps)
    return {**{k: float(v) for k, v in metrics.items()}, "mat_precision": precision,
            "mat_recall": recall,
            "mat_f1": 2 * precision * recall / (precision + recall + eps)}


def _setup(data_dir, num_points, max_num_part, batch_size, seed, val_data_dir, model,
           epochs, lr, device):
    """-> (train loader, val loader or None, state at its seeded init or ``model``'s)."""
    loader = Loader(AllPieceMatchingDataset(data_dir, num_points=num_points,
                                            max_num_part=max_num_part), batch_size, seed=seed)
    val_loader = None
    if val_data_dir:
        val_loader = Loader(AllPieceMatchingDataset(val_data_dir, num_points=num_points,
                                                    max_num_part=max_num_part),
                            batch_size, shuffle=False, drop_last=False, seed=seed)
    if model is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = make_model()
    model = model.to(device).reduce_over(mesh.data_group())
    return loader, val_loader, adam_cosine(model, lr, epochs * max(len(loader), 1))


def train_matching(data_dir: str, out_dir: str = "output/matching", epochs: int = 250,
                   batch_size: int = 1, num_points: int = 5000, lr: float = 1e-3,
                   mat_epoch: int = 10, rig_epoch: int = 200, seed: int = 123,
                   max_steps: int | None = None, model: JigsawModel | None = None,
                   max_num_part: int = 20, val_data_dir: str | None = None,
                   val_every: int = 50, top_k: int = 10, cls_pos_weight: float = 1.0,
                   num_devices: int = 1, log_every: int = 20, device=None,
                   join_timeout_s: float | None = None) -> TrainState:
    """Train ``model`` (default: ``make_model()`` drawn from ``seed``) through
    ``training/loop.py`` and return its state. Runs on ``cuda`` unless ``device="cpu"``, on
    ``num_devices`` processes (``parallel/mesh.py::world_size``; -1 every visible card)."""
    device = resolve_device(device)
    kw = dict(out_dir=out_dir, epochs=epochs, batch_size=batch_size, num_points=num_points,
              lr=lr, mat_epoch=mat_epoch, rig_epoch=rig_epoch, seed=seed,
              max_steps=max_steps, model=model, max_num_part=max_num_part,
              val_data_dir=val_data_dir, val_every=val_every, top_k=top_k,
              cls_pos_weight=cls_pos_weight, num_devices=num_devices, log_every=log_every,
              device=device)
    setup = (data_dir, num_points, max_num_part, batch_size, seed, val_data_dir, model,
             epochs, lr, device)
    done = loop.spawned(out_dir, lambda: _setup(*setup)[2],
                        functools.partial(train_matching, data_dir, **kw), (), num_devices,
                        device, batch_size, join_timeout_s)
    if done is not None:
        return done
    loader, val_loader, state = _setup(*setup)

    def step_fn(epoch, batch):
        w_mat = 1.0 if epoch >= mat_epoch else 0.0
        w_rig = 1.0 if epoch >= rig_epoch else 0.0
        return train_step(state, device_batch(batch, device), w_mat, w_rig, cls_pos_weight)

    def validate():
        # every rank holds each batch whole, as the JAX trainer replicates them
        accs = [eval_step(state.model, to_device(vb, device)) for vb in val_loader or ()]
        if not accs:
            return None
        agg = {k: float(np.mean([a[k] for a in accs])) for k in accs[0]}
        return {f"val_{k}": v for k, v in agg.items()}, agg["mat_f1"]

    # top-k on val mat_f1 and auto-resume (the reference train_matching.py:41-49, 77-101)
    topk = dict(monitor="mat_f1", mode="max", top_k=top_k)
    return loop.fit(state, out_dir, loader, epochs, step_fn, validate, topk, val_every,
                    log_every, max_steps)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = dict(a.split("=", 1) for a in argv if "=" in a)
    train_matching(
        args.get("data_dir", "pc_data/everyday/train"),
        out_dir=args.get("out_dir", "output/matching"),
        epochs=int(args.get("epochs", 250)),
        batch_size=int(args.get("batch_size", 1)),
        num_points=int(args.get("num_points", 5000)),
        lr=float(args.get("lr", 1e-3)),
        mat_epoch=int(args.get("mat_epoch", 10)),
        rig_epoch=int(args.get("rig_epoch", 200)),
        max_num_part=int(args.get("max_num_part", 20)),
        val_data_dir=args.get("val_data_dir") or None,
        val_every=int(args.get("val_every", 50)),
        max_steps=int(args["max_steps"]) if "max_steps" in args else None,
        cls_pos_weight=float(args.get("cls_pos_weight", 1.0)),
        num_devices=int(args.get("num_devices", 1)),
        device="cpu" if "--cpu" in argv else None,
    )


if __name__ == "__main__":
    main()
