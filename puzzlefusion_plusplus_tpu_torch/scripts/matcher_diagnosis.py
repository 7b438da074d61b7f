"""The matcher's bottleneck decomposition (port of ``scripts/matcher_diagnosis.py``): one
trained checkpoint scored under four regimes on the same batches of the val and train
splits, to find the stage that loses held-out ``mat_f1``.

  regime                       | score matrix       | critical points | discretization
  A production (pred cls)      | learned affinities | predicted       | Hungarian
  B val monitor (gt cls)       | learned affinities | GT labels       | Hungarian
  C oracle scores + Sinkhorn   | -||gt_i - gt_j||^2 | GT labels       | Sinkhorn+Hungarian
  D oracle scores direct       | -||gt_i - gt_j||^2 | GT labels       | Hungarian

B - A is the cost of the fracture-point classifier, C and D - B that of the learned
affinities, D against 1.0 the metric's own gap (its GT "permutation" is the row-wise nearest
neighbour, not a permutation: ``matching/oracle.py``), train B - val B overfitting against not
learning. The reference evaluates regime A through eval.sh (matching_base_model.py:274-454)
and monitors regime B in training (train_matching.py:41-49). No weight enters C and D.

The device half (``diag_forward``: two eval-mode forwards, with GT and with predicted labels,
the GT permutation over the GT-compacted critical points, the oracle scores at the batch's
mean cross-piece nearest-neighbour d², the classifier's masked counts) runs on the card;
the host half (``split_stats``: the Hungarian per regime, tp/fp/fn, F1 to 4 places) on the
host. The JAX script runs on the CPU unless told otherwise (its ``DIAG_BACKEND``); this one
runs on the card unless given ``--cpu``, as every entry of the port does.

``CKPT=<tmp>/pfpp_torch_m6/out/ckpt DATA=<tmp>/pfpp_torch_m6 NUM_POINTS=1000 MAX_PARTS=6
BATCH=4 N_SHAPES=16 PC_FEAT=64 AFF_FEAT=128 SA_NPOINTS=256,128,64,16 [OUT_TAG=...]
CANONICALIZE=0 python -m puzzlefusion_plusplus_tpu_torch.scripts.matcher_diagnosis [--cpu]``
writes ``chiprun_out/evidence/<OUT_TAG>/matcher/bottleneck_decomposition.summary.json``
(OUT_TAG defaults to DATA's base name).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device
from puzzlefusion_plusplus_tpu_torch.matching import ops as mops
from puzzlefusion_plusplus_tpu_torch.matching.dataset import AllPieceMatchingDataset
from puzzlefusion_plusplus_tpu_torch.matching.model import gt_permutation
from puzzlefusion_plusplus_tpu_torch.matching.sinkhorn import hungarian, sinkhorn_log
from puzzlefusion_plusplus_tpu_torch.matching.train import make_model
from puzzlefusion_plusplus_tpu_torch.scripts import Clock, cli_device, env_int, run_root
from puzzlefusion_plusplus_tpu_torch.scripts.evidence import EVIDENCE_DIR, write_summary
from puzzlefusion_plusplus_tpu_torch.training.state import best_checkpoint, load_model_state
from puzzlefusion_plusplus_tpu_torch.training.vqvae import to_device

REGIMES = {
    "A": "pred-cls selection + learned affinities (production, eval.sh)",
    "B": "GT-cls selection + learned affinities (val monitor)",
    "C": "GT-cls + oracle -d2 scores through Sinkhorn+Hungarian",
    "D": "GT-cls + oracle -d2 scores, Hungarian direct",
}


def _gt_critical(gt_pcs, order, slot_valid, cross):
    """The GT-pose points of the compacted critical slots (1e3 on the empty ones) and the GT
    permutation over them."""
    gt_crit = torch.take_along_dim(gt_pcs, order[..., None], dim=1)
    gt_crit = torch.where(slot_valid[..., None], gt_crit, 1e3)
    return gt_crit, gt_permutation(gt_crit, cross)


def _labels(batch):
    pid = batch["piece_id"]
    n_valid = batch["part_valids"].sum(-1).to(torch.int32)
    return pid, n_valid, mops.fracture_point_labels(batch["gt_pcs"], pid, n_valid,
                                                    batch["critical_label_thresholds"])


@torch.no_grad()
def oracle_regimes(batch: dict, iters: int = 20, tau: float = 0.05) -> dict:
    """Regimes C and D of a batch of tensors, which depend on no weight: the GT labels'
    critical points compacted as the model compacts them, the oracle scores -d² over the
    batch's mean cross-piece nearest-neighbour d² (a peaky automatic temperature), through
    ``sinkhorn_log`` at the model's ``iters`` and ``tau`` (C) and raw (D, the Hungarian
    maximizes). -> {name: (scores, n_crit, gt_perm, cross)}."""
    pid, n_valid, labels = _labels(batch)
    slot_valid, (crit_pid,), order = mops.compact_critical(labels, pid[..., None])
    crit_pid = torch.where(slot_valid, crit_pid[..., 0], n_valid[:, None])
    cross = ((crit_pid[:, :, None] != crit_pid[:, None, :])
             & slot_valid[:, :, None] & slot_valid[:, None, :])
    gt_crit, gtp = _gt_critical(batch["gt_pcs"], order, slot_valid, cross)
    n_crit = labels.sum(-1)
    d2 = mops.square_distance(gt_crit, gt_crit)
    nn_d2 = torch.where(cross, d2, 1e6).amin(-1)  # [B, Nc]
    row_valid = nn_d2 < 1e5
    scale = (torch.where(row_valid, nn_d2, 0.0).sum(-1)
             / row_valid.sum(-1).clamp_min(1))  # [B] the mean cross-piece NN d²
    s_oracle = torch.where(cross, -d2 / scale.clamp_min(1e-12)[:, None, None], -1e6)
    ds_oracle = sinkhorn_log(s_oracle, n_crit, n_crit, iters, tau)
    return {"C": (ds_oracle, n_crit, gtp, cross), "D": (s_oracle, n_crit, gtp, cross)}


@torch.no_grad()
def diag_forward(model, batch: dict) -> tuple[dict, dict]:
    """The device half on a batch of tensors -> ({regime: (scores, n_crit, gt_perm, cross)},
    the classifier's masked tp/fp/fn counts under predicted labels)."""
    model.eval()
    pid, n_valid, labels = _labels(batch)

    def forward(use_pred):
        out = model(batch["part_pcs"], pid, n_valid, labels, compute_matching=True,
                    use_pred_labels=use_pred)
        _, gtp = _gt_critical(batch["gt_pcs"], out["crit_order"], out["crit_slot_valid"],
                              out["s_mask"])
        return out, gtp

    out_gt, gtp_gt = forward(False)
    out_pr, gtp_pr = forward(True)
    valid = mops.valid_point_mask(pid, n_valid).float()
    pred, gt = out_pr["cls_pred"].float(), labels.float()
    cls = {"cls_tp": (valid * pred * gt).sum(), "cls_fp": (valid * pred * (1 - gt)).sum(),
           "cls_fn": (valid * (1 - pred) * gt).sum()}
    return {
        "A": (out_pr["ds_mat"], out_pr["n_critical_sum"], gtp_pr, out_pr["s_mask"]),
        "B": (out_gt["ds_mat"], out_gt["n_critical_sum"], gtp_gt, out_gt["s_mask"]),
        **oracle_regimes(batch, model.sinkhorn_iters, model.sinkhorn_tau),
    }, cls


def model_fn(model, device):
    """``diag_forward`` of ``model`` on a loader batch, its outputs as numpy arrays."""
    def fn(batch):
        regimes, cls = diag_forward(model, to_device(batch, device))
        return ({k: tuple(a.cpu().numpy() for a in v) for k, v in regimes.items()},
                {k: v.item() for k, v in cls.items()})
    return fn


def regime_counts(scores, n_crit, gtp, cross) -> np.ndarray:
    """[tp, fp, fn] of the Hungarian assignment of each sample's critical block against the
    GT permutation, over the cross-piece pairs (numpy arrays)."""
    perm = hungarian(np.asarray(scores), np.asarray(n_crit), np.asarray(n_crit))
    gtp, cross = np.asarray(gtp), np.asarray(cross)
    return np.array([float((perm * gtp * cross).sum()), float((perm * (1 - gtp) * cross).sum()),
                     float(((1 - perm) * gtp * cross).sum())])


def f1(v) -> dict:
    eps = 1e-7
    p, r = v[0] / (v[0] + v[1] + eps), v[0] / (v[0] + v[2] + eps)
    return {"precision": round(p, 4), "recall": round(r, 4),
            "f1": round(2 * p * r / (p + r + eps), 4)}


def split_stats(data_dir: str, fn, num_points: int = 1000, max_parts: int = 6,
                batch: int = 4, n_shapes: int = 16) -> dict:
    """The host half over the first batches of a split holding ``n_shapes`` shapes:
    ``fn(loader batch) -> (regimes of numpy arrays, cls counts or None)`` -> the F1 of each
    regime (and of the classifier, with counts) and the shapes seen."""
    ds = AllPieceMatchingDataset(data_dir, num_points=num_points, max_num_part=max_parts)
    agg, cls_agg, seen = {}, None, 0
    for b in Loader(ds, batch, shuffle=False, drop_last=False, seed=0):
        if seen >= n_shapes:
            break
        regimes, cls = fn(b)
        if cls is not None:
            counts = np.array([cls["cls_tp"], cls["cls_fp"], cls["cls_fn"]], np.float64)
            cls_agg = counts if cls_agg is None else cls_agg + counts
        for name, arrays in regimes.items():
            agg[name] = agg.get(name, 0.0) + regime_counts(*arrays)
        seen += int(b["part_pcs"].shape[0])
    out = {name: f1(v) for name, v in agg.items()}
    if cls_agg is not None:
        out["cls"] = f1(cls_agg)
    out["n_shapes"] = seen
    return out


def run(data: str, ckpt: str, num_points: int = 1000, max_parts: int = 6, batch: int = 4,
        n_shapes: int = 16, pc_feat: int = 64, aff_feat: int = 128,
        sa_npoints=(256, 128, 64, 16), out_tag: str | None = None, canonicalize: bool = False,
        device=None, evidence_dir: str | None = None) -> dict:
    """Both splits of the run root ``data`` under the best checkpoint of ``ckpt`` -> the
    decomposition it writes."""
    device = resolve_device(device)
    clock = Clock()
    model = make_model(pc_feat_dim=pc_feat, aff_feat_dim=aff_feat, sa_npoints=tuple(sa_npoints),
                       canonicalize=canonicalize)
    best = best_checkpoint(ckpt)
    if best is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt}")
    model.load_state_dict(load_model_state(best))
    model.to(device)
    clock.say(f"loaded {best}")
    result = {"ckpt": best, "num_points": num_points, "max_parts": max_parts,
              "regimes": dict(REGIMES)}
    fn = model_fn(model, device)
    for split in ("val", "train"):
        result[split] = split_stats(os.path.join(data, "pc_data", split), fn, num_points,
                                    max_parts, batch, n_shapes)
        clock.say(f"{split}: {json.dumps(result[split])}")
    ev_dir = os.path.join(evidence_dir or EVIDENCE_DIR,
                          out_tag or os.path.basename(data.rstrip("/")), "matcher")
    os.makedirs(ev_dir, exist_ok=True)
    write_summary(ev_dir, "bottleneck_decomposition", result)
    print(f"wrote {ev_dir}/bottleneck_decomposition.summary.json", flush=True)
    return result


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = cli_device(argv)
    data = os.environ.get("DATA", run_root("m6"))
    return run(data, os.environ.get("CKPT", os.path.join(run_root("m6"), "out", "ckpt")),
               num_points=env_int("NUM_POINTS", 1000), max_parts=env_int("MAX_PARTS", 6),
               batch=env_int("BATCH", 4), n_shapes=env_int("N_SHAPES", 16),
               pc_feat=env_int("PC_FEAT", 64), aff_feat=env_int("AFF_FEAT", 128),
               sa_npoints=tuple(int(x) for x in
                                os.environ.get("SA_NPOINTS", "256,128,64,16").split(",")),
               out_tag=os.environ.get("OUT_TAG"),
               canonicalize=os.environ.get("CANONICALIZE", "0") == "1", device=device)


if __name__ == "__main__":
    main()
