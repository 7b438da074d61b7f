"""All-piece matching dataset (the reference's AllPieceMatchingDataset, flat-layout): a copy
of ``puzzlefusion_plusplus_tpu/matching/dataset.py``, numpy only, so that the same loader seed
serves the same samples.

Emits the exact field contract of Jigsaw_matching/dataset/all_piece_matching_dataset.py
(:226-279): flat ``part_pcs``/``gt_pcs`` [N_sum, 3], per-piece 7-DoF GT pose, ``n_pcs``,
``critical_label_thresholds`` — plus a dense ``piece_id`` [N_sum] for the fixed-shape model.

Point sampling: the reference samples meshes area-proportionally with a min-30 greedy
rebalance (:164-193). Without meshes we sample from the stored per-part clouds in pc_data
.npz with the same proportional+rebalance logic, using bounding-box surface area as the area
proxy; augmentation (per-piece recenter + uniform random rotation + shuffle) is exact.
"""

from __future__ import annotations

import numpy as np

from puzzlefusion_plusplus_tpu_torch.data.datasets import (
    _pad,
    _recenter_pc,
    _rotate_pc,
    load_pc_data_dir,
)


def sample_points_by_areas(areas: np.ndarray, num_points: int) -> np.ndarray:
    """Ceil-proportional allocation, largest part absorbs the rounding (:164-168)."""
    nps = np.ceil(areas * num_points / areas.sum()).astype(np.int64)
    nps[np.argmax(nps)] -= nps.sum() - num_points
    return nps


def sample_reweighted_points_by_areas(
    areas: np.ndarray, num_points: int, min_part_point: int = 30
) -> np.ndarray:
    """Min-points greedy rebalance taking from the largest parts (:170-192)."""
    nps = sample_points_by_areas(areas, num_points)
    if min_part_point <= 1:
        return nps
    if num_points < len(areas) * min_part_point:
        # the rebalance loop below cannot terminate once every part sits at the minimum
        raise ValueError(
            f"num_points={num_points} cannot give all {len(areas)} parts >= "
            f"{min_part_point} points; raise num_points or lower min_part_point"
        )
    delta = 0
    for i in range(len(nps)):
        if nps[i] < min_part_point:
            delta += min_part_point - nps[i]
            nps[i] = min_part_point
    while delta > 0:
        k = np.argmax(nps)
        if nps[k] - delta >= min_part_point:
            nps[k] -= delta
            delta = 0
        else:
            delta -= nps[k] - min_part_point
            nps[k] = min_part_point
    return nps.astype(np.int64)


def bbox_area_proxy(pc: np.ndarray) -> float:
    """Bounding-box surface area — the mesh-free stand-in for trimesh mesh.area."""
    ext = pc.max(0) - pc.min(0)
    return float(2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[0] * ext[2]))


class AllPieceMatchingDataset:
    def __init__(
        self,
        data_dir: str,
        num_points: int = 5000,
        max_num_part: int = 20,
        min_num_part: int = 2,
        min_part_point: int = 30,
        fracture_label_threshold: float = 0.025,
        overfit: int = -1,
    ):
        self.num_points = num_points
        self.max_num_part = max_num_part
        self.min_part_point = min_part_point
        self.fracture_label_threshold = fracture_label_threshold
        self.data_list = [
            s for s in load_pc_data_dir(data_dir, overfit)
            if min_num_part <= int(s["num_parts"]) <= max_num_part
        ]

    def __len__(self):
        return len(self.data_list)

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        s = self.data_list[idx]
        num_parts = int(s["num_parts"])
        parts = [s["part_pcs_gt"][i] for i in range(num_parts)]
        areas = np.array([bbox_area_proxy(p) for p in parts])
        nps = sample_reweighted_points_by_areas(areas, self.num_points, self.min_part_point)

        cur_pts, cur_quat, cur_trans, cur_pts_gt, piece_id = [], [], [], [], []
        for i in range(num_parts):
            src = parts[i]
            sel = rng.choice(len(src), int(nps[i]), replace=int(nps[i]) > len(src))
            pc_gt = src[sel]
            pc, gt_trans = _recenter_pc(pc_gt.copy())
            pc, gt_quat = _rotate_pc(pc, rng)
            order = rng.permutation(len(pc))
            cur_pts.append(pc[order])
            cur_pts_gt.append(pc_gt[order])
            cur_quat.append(gt_quat)
            cur_trans.append(gt_trans)
            piece_id.append(np.full(int(nps[i]), i, np.int32))

        return {
            "part_pcs": np.concatenate(cur_pts).astype(np.float32),
            "gt_pcs": np.concatenate(cur_pts_gt).astype(np.float32),
            "piece_id": np.concatenate(piece_id),
            "part_valids": _pad(np.ones((num_parts, 1), np.float32), self.max_num_part)[:, 0],
            "part_quat": _pad(np.stack(cur_quat), self.max_num_part),
            "part_trans": _pad(np.stack(cur_trans), self.max_num_part),
            "n_pcs": _pad(nps[:, None].astype(np.float32), self.max_num_part)[:, 0]
            .astype(np.int64),
            "data_id": int(s["data_id"]),
            "critical_label_thresholds": np.full(
                self.num_points, self.fracture_label_threshold, np.float32
            ),
            "num_parts": num_parts,
            "mesh_file_path": str(s["mesh_file_path"]),
        }
