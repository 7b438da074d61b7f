"""Offline matching-data generation (port of ``puzzlefusion_plusplus_tpu/matching/
generate.py``, the reference's eval_matching.py -> _save_data path).

The trained matcher runs in test mode (its own fracture labels) on the card; the host half,
``write_matching_shape``, takes the forward's outputs and writes one
``matching_data/{data_id}.npz`` in the reference schema (matching_base_model.py:614-640:
``edges`` [(idx2, idx1)], per-edge correspondence index pairs, ``gt_pcs``,
``critical_pcs_idx`` (flat per-part local indices), ``n_pcs``, ``n_critical_pcs``): Hungarian
over the critical slots, the matches of each part pair, a numpy RANSAC + Horn transform per
pair, then the pose-graph global alignment anchored at the largest piece's GT pose. Fed the
JAX forward's outputs, it writes the arrays the JAX writer writes.
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
from puzzlefusion_plusplus_tpu_torch.matching.alignment import global_alignment
from puzzlefusion_plusplus_tpu_torch.matching.dataset import AllPieceMatchingDataset
from puzzlefusion_plusplus_tpu_torch.matching.sinkhorn import hungarian

FORWARD_KEYS = ("cls_pred", "ds_mat", "n_critical_sum", "crit_pid")


def _horn_numpy(src, tgt, w):
    """Weighted Kabsch/Horn on the host: minimises sum w ||src @ r.T + t - tgt||^2."""
    w = np.asarray(w, np.float64)[:, None]
    ws = max(w.sum(), 1e-12)
    cs = (src * w).sum(0) / ws
    ct = (tgt * w).sum(0) / ws
    h = ((src - cs) * w).T @ (tgt - ct)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    return r, ct - r @ cs


def _ransac_numpy(src, tgt, rng, iters=128, threshold=0.02):
    """Host RANSAC on hard correspondences (in place of the reference's open3d call) ->
    a 4x4 transform."""
    n = len(src)
    best_inliers = None
    best_count = -1
    for _ in range(iters):
        idx = rng.integers(0, n, 3)
        r, t = _horn_numpy(src[idx], tgt[idx], np.ones(3))
        inliers = np.linalg.norm(src @ r.T + t - tgt, axis=-1) < threshold
        c = inliers.sum()
        if c > best_count:
            best_count, best_inliers = c, inliers
    w = best_inliers.astype(np.float64) if best_count >= 3 else np.ones(n)
    r, t = _horn_numpy(src, tgt, w)
    m = np.eye(4)
    m[:3, :3] = r
    m[:3, 3] = t
    return m


def write_matching_shape(out: dict, batch: dict, out_dir: str, rng: np.random.Generator,
                         max_num_part: int = 20) -> dict:
    """The host half for one shape: ``out`` holds ``FORWARD_KEYS`` as numpy arrays of a
    batch of 1, ``batch`` the loader's batch of 1. Writes ``{data_id}.npz`` into ``out_dir``
    -> the shape's stats (edges written, critical points, global transforms [P, 4, 4])."""
    labels = np.asarray(out["cls_pred"])[0]
    n_pcs = np.asarray(batch["n_pcs"][0])
    num_parts = int(batch["num_parts"][0])
    offsets = np.concatenate([[0], np.cumsum(n_pcs)]).astype(np.int64)

    # per-part local critical indices, flat layout (the reference's critical_pcs_idx)
    n_critical = np.zeros(max_num_part, np.int64)
    critical_pcs_idx = np.zeros(int(n_pcs.sum()), np.int64)
    for i in range(num_parts):
        local = np.where(labels[offsets[i]:offsets[i + 1]] == 1)[0]
        n_critical[i] = len(local)
        critical_pcs_idx[offsets[i]:offsets[i] + len(local)] = local

    # the hard assignment over the compacted critical slots
    n_crit_sum = int(np.asarray(out["n_critical_sum"])[0])
    perm = hungarian(np.asarray(out["ds_mat"])[:1], np.asarray([n_crit_sum]),
                     np.asarray([n_crit_sum]))[0]
    crit_pid = np.asarray(out["crit_pid"])[0]
    slot_local = np.zeros(len(crit_pid), np.int64)  # slot -> the part's local critical index
    counters: dict = {}
    for sidx in range(n_crit_sum):
        p = int(crit_pid[sidx])
        slot_local[sidx] = counters.get(p, 0)
        counters[p] = counters.get(p, 0) + 1

    part_pcs = np.asarray(batch["part_pcs"][0])
    gt_pcs = np.asarray(batch["gt_pcs"][0])
    edges, corr_list, transformations, uncertainty = [], [], [], []
    for idx1, idx2 in itertools.combinations(range(num_parts), 2):
        rows = np.where(crit_pid[:n_crit_sum] == idx1)[0]
        cols = np.where(crit_pid[:n_crit_sum] == idx2)[0]
        if len(rows) == 0 or len(cols) == 0:
            continue
        sub = perm[np.ix_(rows, cols)]
        sub2 = perm[np.ix_(cols, rows)]
        if sub.sum() < sub2.sum():
            sub = sub2.T
        r_i, c_i = np.nonzero(sub)
        if len(r_i) < 3:
            continue
        corr = np.stack([slot_local[rows[r_i]], slot_local[cols[c_i]]], axis=1)
        # the matched points in the augmented (local) frame
        src_pts = part_pcs[offsets[idx1] + critical_pcs_idx[offsets[idx1] + corr[:, 0]]]
        tgt_pts = part_pcs[offsets[idx2] + critical_pcs_idx[offsets[idx2] + corr[:, 1]]]
        transformations.append(_ransac_numpy(src_pts, tgt_pts, rng))
        edges.append([idx2, idx1])
        corr_list.append(corr.astype(np.int64))
        uncertainty.append(1.0 / max(len(r_i), 1))

    data_id = int(batch["data_id"][0])
    np.savez(os.path.join(out_dir, f"{data_id}.npz"),
             edges=np.asarray(edges, np.int64).reshape(-1, 2),
             correspondence=np.asarray(corr_list, dtype=object),
             gt_pcs=gt_pcs.astype(np.float32), critical_pcs_idx=critical_pcs_idx,
             n_pcs=n_pcs[:num_parts].astype(np.int64),
             n_critical_pcs=n_critical[:num_parts])

    # global alignment anchored at the largest piece's GT pose (the reference :431-453)
    if edges:
        from scipy.spatial.transform import Rotation as R

        glob = global_alignment(num_parts, np.asarray(edges), np.stack(transformations),
                                np.asarray(uncertainty))
        pivot = int(np.argmax(n_pcs[:num_parts]))
        quat = np.asarray(batch["part_quat"][0, pivot])
        to_gt = np.eye(4)
        to_gt[:3, :3] = R.from_quat(quat[[1, 2, 3, 0]]).as_matrix()
        to_gt[:3, 3] = np.asarray(batch["part_trans"][0, pivot])
        glob = (to_gt @ np.linalg.inv(glob[pivot]))[None] @ glob
    else:
        glob = np.repeat(np.eye(4)[None], num_parts, axis=0)
    return {"data_id": data_id, "num_edges": len(edges),
            "n_critical_total": int(n_critical.sum()), "global_transforms": glob}


@torch.no_grad()
def matcher_forward(model, batch: dict, device) -> dict:
    """The test-mode forward (the classifier's own labels) on one loader batch ->
    ``FORWARD_KEYS`` as numpy arrays."""
    model.eval()
    pid = torch.from_numpy(batch["piece_id"]).to(device)
    n_valid = torch.from_numpy(batch["part_valids"]).to(device).sum(-1).to(torch.int32)
    out = model(torch.from_numpy(batch["part_pcs"]).to(device), pid, n_valid,
                torch.zeros_like(pid), compute_matching=True, use_pred_labels=True)
    return {k: out[k].cpu().numpy() for k in FORWARD_KEYS}


def generate_matching_data(model, data_dir: str, out_dir: str, num_points: int = 5000,
                           max_num_part: int = 20, max_samples: int | None = None,
                           seed: int = 0, device="cuda") -> list[dict]:
    """Run ``model`` in test mode over ``data_dir``'s shapes (one a batch) and write their
    matching_data npz files into ``out_dir`` -> the per-shape stats."""
    os.makedirs(out_dir, exist_ok=True)
    ds = AllPieceMatchingDataset(data_dir, num_points=num_points, max_num_part=max_num_part)
    loader = Loader(ds, 1, shuffle=False, drop_last=False, seed=seed)
    rng = np.random.default_rng(seed)
    results = []
    for bi, batch in enumerate(loader):
        if max_samples is not None and bi >= max_samples:
            break
        results.append(write_matching_shape(matcher_forward(model, batch, device), batch,
                                            out_dir, rng, max_num_part))
    return results
