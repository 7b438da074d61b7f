"""Structural ceiling for the matching-F1 metric (host-side numpy diagnostic): a copy of
``puzzlefusion_plusplus_tpu/matching/oracle.py``.

The reference's ``mat_f1`` (Jigsaw_matching/model/jigsaw/joint_seg_align_model.py:330-424)
scores a ONE-TO-ONE predicted assignment (Hungarian-discretized Sinkhorn) against the
row-argmin nearest-neighbor "GT permutation" — which is NOT one-to-one: whenever the
cross-piece NN graph is non-mutual (dense sampling creates near-ties along fracture
surfaces), no permutation can hit every row's argmin, so even a perfect matcher scores
below 1. ``oracle_matching_stats`` measures that ceiling: the F1 of a Hungarian assignment
computed on the TRUE GT-pose distances — the best any distance-informed matcher evaluated
by this metric can do at a given dataset / sampling density. Report achieved/oracle.

Measured on the synthetic gen sets (VALIDATION.md "Matching F1 oracle ceiling"): the
ceiling FALLS with sampling density (0.70 @ 1000 pts -> 0.44 @ 2500 pts on the 4096-shape
val split) because denser fracture surfaces are less NN-mutual; pick the matcher operating
point with the ceiling in hand.
"""

from __future__ import annotations

import numpy as np

from puzzlefusion_plusplus_tpu_torch.matching.dataset import AllPieceMatchingDataset


def oracle_f1_single(
    gt_pcs: np.ndarray,  # [N, 3] GT-pose points of one shape (all pieces, flat)
    piece_id: np.ndarray,  # [N] piece id per point
    threshold: float,  # fracture-point distance threshold (matching/ops.py:67-80 rule)
) -> dict:
    """Oracle stats for one shape: Hungarian on true distances vs the argmin-NN GT perm.

    Returns oracle_f1 (= precision = recall: both assignments are one-to-one over the same
    critical set), mutual_nn_frac, and n_crit. Shapes with < 2 critical points return NaN.
    """
    # float32 + row-chunked NN scan via the |x|^2 + |y|^2 - 2<x,y> identity (the
    # matching/ops.py::square_distance formulation): peak extra memory is one
    # [chunk, N] block (the broadcast (x-y)**2 form would materialize [chunk, N, 3]
    # temporaries, about 3x as much) and the -2xy term is a matmul
    pts = np.ascontiguousarray(gt_pcs, dtype=np.float32)
    n_pts = len(pts)
    sq = (pts * pts).sum(-1)
    chunk = 2048
    nn_cross_d2 = np.empty(n_pts, dtype=np.float32)
    for s in range(0, n_pts, chunk):
        e = min(s + chunk, n_pts)
        blk = sq[s:e, None] + sq[None, :] - 2.0 * (pts[s:e] @ pts.T)
        blk[piece_id[s:e, None] == piece_id[None, :]] = np.inf
        np.maximum(blk, 0.0, out=blk)  # matmul rounding can dip slightly negative
        nn_cross_d2[s:e] = blk.min(-1)
    crit = nn_cross_d2 < threshold * threshold
    ci = np.where(crit)[0]
    if len(ci) < 2:
        return {"oracle_f1": float("nan"), "assignment_ceiling": float("nan"),
                "mutual_nn_frac": float("nan"), "n_crit": len(ci)}
    dc = ((pts[ci, None, :] - pts[None, ci, :]) ** 2).sum(-1)
    dc[piece_id[ci, None] == piece_id[None, ci]] = np.inf
    gt_nn = dc.argmin(-1)  # the metric's GT "permutation": row-argmin NN
    mutual = float((gt_nn[gt_nn] == np.arange(len(ci))).mean())
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(np.where(np.isfinite(dc), dc, 1e12))
    tp = float((cols == gt_nn[rows]).sum())
    # hard combinatorial ceiling for ANY one-to-one prediction (learned or not): each row's
    # single admissible column is gt_nn[row], so the max bipartite matching picks one row
    # per DISTINCT argmin column — F1_max = |distinct(gt_nn)| / n
    ceiling = float(len(np.unique(gt_nn))) / len(ci)
    return {
        "oracle_f1": tp / len(ci),
        "assignment_ceiling": ceiling,
        "mutual_nn_frac": mutual,
        "n_crit": len(ci),
    }


def oracle_matching_stats(
    data_dir: str,
    num_points: int = 1000,
    max_num_part: int = 20,
    num_shapes: int | None = None,
    seed: int = 0,
    fracture_label_threshold: float = 0.025,
) -> dict:
    """Dataset-level oracle ceiling at the exact sampling policy the matcher trains with
    (AllPieceMatchingDataset: area-proportional + min-30 rebalance + per-epoch resample)."""
    ds = AllPieceMatchingDataset(
        data_dir, num_points=num_points, max_num_part=max_num_part,
        fracture_label_threshold=fracture_label_threshold,
    )
    rng = np.random.default_rng(seed)
    n = len(ds) if num_shapes is None else min(num_shapes, len(ds))
    per = []
    for idx in range(n):
        s = ds.get(idx, rng)
        per.append(
            oracle_f1_single(s["gt_pcs"], s["piece_id"], fracture_label_threshold)
        )
    f1s = np.array([p["oracle_f1"] for p in per])
    ceil = np.array([p["assignment_ceiling"] for p in per])
    mut = np.array([p["mutual_nn_frac"] for p in per])
    ok = ~np.isnan(f1s)
    return {
        "oracle_f1": float(f1s[ok].mean()) if ok.any() else float("nan"),
        "oracle_f1_min": float(f1s[ok].min()) if ok.any() else float("nan"),
        "assignment_ceiling": float(ceil[ok].mean()) if ok.any() else float("nan"),
        "mutual_nn_frac": float(mut[ok].mean()) if ok.any() else float("nan"),
        "n_crit_mean": float(np.mean([p["n_crit"] for p in per])),
        "num_shapes": int(n),
        "num_points": int(num_points),
    }
