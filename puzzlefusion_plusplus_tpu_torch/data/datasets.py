"""Test-mode dataset reader over the pc_data / matching_data .npz schemas.

A copy of ``DenoiserDataset`` from ``puzzlefusion_plusplus_tpu/data/datasets.py`` for the
``val`` and ``test`` modes (training's multi-reference curriculum waits for the training
slice), with the per-part augmentation done in numpy (the numpy fallback of
``utils/native.py::augment_parts_cpu``). Rotations are drawn in the reference rng order, so
the same loader seed yields the same samples as the JAX package's dataset.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.spatial.transform import Rotation as R


def _draw_rotations(num: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """num uniform rotations drawn one by one -> (mats [num, 3, 3], GT quats [num, 4] of
    the transposed mats, scalar-first)."""
    mats = np.empty((num, 3, 3), np.float32)
    quats = np.empty((num, 4), np.float32)
    for i in range(num):
        m = R.random(random_state=rng).as_matrix()
        mats[i] = m
        quats[i] = R.from_matrix(m.T).as_quat()[[3, 0, 1, 2]]
    return mats, quats


def _augment_parts(pcs: np.ndarray, rots: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Recenter + rotate every part: [P, N, 3], [P, 3, 3] -> (out [P, N, 3], centroids)."""
    pcs = np.ascontiguousarray(pcs, np.float32)
    rots = np.ascontiguousarray(rots, np.float32)
    centroids = pcs.mean(axis=1)
    out = np.einsum("pij,pnj->pni", rots, pcs - centroids[:, None, :])
    return out.astype(np.float32), centroids.astype(np.float32)


def _pad(data: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + tuple(data.shape[1:]), dtype=np.float32)
    m = min(n, data.shape[0])
    out[:m] = data[:m]
    return out


def _pad_square(g: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n, n), dtype=g.dtype)
    m = min(n, g.shape[0])
    out[:m, :m] = g[:m, :m]
    return out


def _rotate_pc(pc, rng):
    """Random rotation -> (rotated pc, scalar-first GT quaternion of the inverse)."""
    rot_mat = R.random(random_state=rng).as_matrix()
    return (rot_mat @ pc.T).T, R.from_matrix(rot_mat.T).as_quat()[[3, 0, 1, 2]]


def load_pc_data_dir(data_dir: str, overfit: int = -1) -> list[dict]:
    files = sorted(f for f in os.listdir(data_dir) if f.endswith(".npz"))
    if overfit != -1:
        files = files[:overfit]
    out = []
    for f in files:
        d = np.load(os.path.join(data_dir, f), allow_pickle=True)
        out.append({k: d[k] for k in d.files})
    return out


class DenoiserDataset:
    def __init__(
        self,
        data_dir: str,
        mode: str = "test",  # val | test
        matching_data_path: str | None = None,
        max_num_part: int = 20,
        overfit: int = -1,
        max_area_points_per_part: int | None = None,
        max_corr: int = 128,
        max_edges_dense: int = 380,
    ):
        if mode not in ("val", "test"):
            raise ValueError(f"mode {mode!r}: the port serves val/test data only")
        if mode == "test" and matching_data_path is None:
            raise ValueError("test mode needs matching_data_path")
        self.mode = mode
        self.max_num_part = max_num_part
        self.A = max_area_points_per_part
        self.K = max_corr
        self.E = max_edges_dense

        self.data_list = []
        for s in load_pc_data_dir(data_dir, overfit):
            if mode == "test":
                mfile = os.path.join(matching_data_path, f"{int(s['data_id'])}.npz")
                if not os.path.exists(mfile):
                    continue
                m = np.load(mfile, allow_pickle=True)
                s["matching"] = {k: m[k] for k in m.files}
            self.data_list.append(s)
        if mode == "test" and self.data_list:
            # per-part area pad sized to the dataset, rounded up to a multiple of 128
            observed = max(int(s["matching"]["n_pcs"].max()) for s in self.data_list)
            if self.A is None or self.A < observed:
                self.A = -(-observed // 128) * 128
        elif self.A is None:
            self.A = 128

    def __len__(self):
        return len(self.data_list)

    def num_parts_list(self) -> np.ndarray:
        return np.asarray([int(s["num_parts"]) for s in self.data_list], np.int32)

    def _densify_matching(self, d: dict, matching: dict) -> dict:
        """Ragged matching arrays -> dense fixed-shape arrays in the sample frame."""
        P, A, K, E = self.max_num_part, self.A, self.K, self.E
        n_pcs = matching["n_pcs"].astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(n_pcs)])
        area = d.pop("part_pcs_by_area")
        num_parts = d["num_parts"]

        area_pts = np.zeros((P, A, 3), np.float32)
        n_area = np.zeros(P, np.int32)
        for i in range(num_parts):
            n = int(n_pcs[i])
            if n > A:
                raise ValueError(f"area points {n} exceed pad {A}")
            area_pts[i, :n] = area[offsets[i] : offsets[i + 1]]
            n_area[i] = n

        critical_idx = matching["critical_pcs_idx"].astype(np.int64)
        n_crit = matching["n_critical_pcs"].astype(np.int64)
        edges = matching["edges"].astype(np.int64).reshape(-1, 2)
        corrs = matching["correspondence"]

        edges_dense = np.zeros((E, 2), np.int32)
        edge_valid = np.zeros(E, bool)
        corr_src = np.zeros((E, K), np.int32)
        corr_tgt = np.zeros((E, K), np.int32)
        corr_count = np.zeros(E, np.int32)
        for e in range(min(len(edges), E)):
            # corr[:, 0] indexes the critical set of edges[e, 1], corr[:, 1] that of edges[e, 0]
            b, a = int(edges[e, 0]), int(edges[e, 1])
            corr = np.asarray(corrs[e]).astype(np.int64).reshape(-1, 2)
            k = min(len(corr), K)
            crit_a = critical_idx[offsets[a] : offsets[a] + n_crit[a]]
            crit_b = critical_idx[offsets[b] : offsets[b] + n_crit[b]]
            edges_dense[e] = (b, a)
            edge_valid[e] = True
            corr_src[e, :k] = crit_a[corr[:k, 0]]
            corr_tgt[e, :k] = crit_b[corr[:k, 1]]
            corr_count[e] = k

        d.update(
            area_pts=area_pts, n_area=n_area, match_edges=edges_dense,
            match_edge_valid=edge_valid, corr_src=corr_src, corr_tgt=corr_tgt,
            corr_count=corr_count,
        )
        return d

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        s = self.data_list[idx]
        num_parts = int(s["num_parts"])
        part_pcs_gt = s["part_pcs_gt"][:num_parts]
        ref_part = s["ref_part"].copy()

        # whole-shape rotation + recenter on the reference part
        flat, pose_gt_r = _rotate_pc(part_pcs_gt.reshape(-1, 3), rng)
        part_pcs_final = flat.reshape(num_parts, -1, 3)
        ref_idx = int(np.where(ref_part[:num_parts])[0].item())
        pose_gt_t = part_pcs_final[ref_idx].mean(axis=0)
        part_pcs_final = part_pcs_final - pose_gt_t

        # per-part recenter + random rotation -> the GT 7-DoF pose
        rot_mats, quats = _draw_rotations(num_parts, rng)
        pts, centroids = _augment_parts(part_pcs_final[:num_parts], rot_mats)
        P = self.max_num_part
        cur_pts = _pad(pts, P)
        cur_quat = _pad(quats, P)
        cur_trans = _pad(centroids, P)

        d = {
            "data_id": int(s["data_id"]),
            "num_parts": num_parts,
            "part_valids": _pad(s["part_valids"][:, None], P)[:, 0],
            "ref_part": _pad(ref_part.astype(np.float32)[:, None], P)[:, 0].astype(bool),
            "graph": _pad_square(s["graph"].astype(np.float32), P).astype(bool),
            "mesh_file_path": str(s["mesh_file_path"]),
        }

        if self.mode == "test":
            # anchor the area cloud into the augmented frame, then move each part to its
            # init (local) pose by undoing the per-part GT trans/rot
            m = s["matching"]
            rot = R.from_quat(pose_gt_r[[1, 2, 3, 0]]).inv()
            anchored = rot.apply(m["gt_pcs"]) - pose_gt_t
            n_pcs = m["n_pcs"].astype(np.int64)
            parts_area = []
            off = 0
            for i in range(num_parts):
                c = anchored[off : off + int(n_pcs[i])] - cur_trans[i]
                parts_area.append(R.from_quat(cur_quat[i][[1, 2, 3, 0]]).inv().apply(c))
                off += int(n_pcs[i])
            d["part_pcs_by_area"] = np.concatenate(parts_area, axis=0).astype(np.float32)

        # per-part max-abs normalize capturing part_scale
        scale = np.max(np.abs(cur_pts), axis=(1, 2), keepdims=True)
        scale[scale == 0] = 1
        d["part_pcs"] = (cur_pts / scale).astype(np.float32)
        d["part_pcs_gt"] = _pad(part_pcs_gt, P)
        d["part_rots"] = cur_quat
        d["part_trans"] = cur_trans
        d["part_scale"] = scale.squeeze(-1).astype(np.float32)  # [P, 1]
        d["init_pose_r"] = pose_gt_r.astype(np.float32)
        d["init_pose_t"] = pose_gt_t.astype(np.float32)
        if self.mode == "test":
            d = self._densify_matching(d, s["matching"])
        return d
