"""Dataset readers over the pc_data / matching_data .npz schemas.

Copies of ``VQVAEDataset``, ``DenoiserDataset`` (train, val and test modes),
``VerifierDataset`` and the helpers the matcher's dataset uses (``_recenter_pc``) from
``puzzlefusion_plusplus_tpu/data/datasets.py``, with the per-part augmentation in the native
host core, as there (``utils/native.py::augment_parts_cpu``: the port's own build of the same
C++ source, or its numpy fallback without a compiler). Rotations and the training
curriculum's draws come in the reference rng order, so the same loader seed yields the same
samples as the JAX package's datasets, bit for bit when both run the native library.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.spatial.transform import Rotation as R

from puzzlefusion_plusplus_tpu_torch.models.scheduler import piecewise_betas
from puzzlefusion_plusplus_tpu_torch.utils import native

MAX_EDGES = 190  # 20 * 19 / 2: the upper triangle of the 20-part pad


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


def _recenter_pc(pc):
    centroid = pc.mean(axis=0)
    return pc - centroid[None], centroid


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


class VQVAEDataset:
    """Per-part recentre and random rotation, pad to ``max_num_part``, per-part max-abs
    normalisation (reference vqvae/dataset/pc_dataset.py:94-115)."""

    def __init__(self, data_dir: str, max_num_part: int = 20, min_num_part: int = 2,
                 overfit: int = -1, category: str = ""):
        """``category``: one Breaking Bad category only ('' or 'all' = every one)."""
        self.max_num_part = max_num_part
        cat = "" if category.lower() == "all" else category
        self.data_list = [
            s for s in load_pc_data_dir(data_dir, overfit)
            if min_num_part <= int(s["num_parts"]) <= max_num_part
            and (not cat or str(s.get("category", "")) == cat)
        ]

    def __len__(self):
        return len(self.data_list)

    def num_parts_list(self) -> np.ndarray:
        return np.asarray([int(s["num_parts"]) for s in self.data_list], np.int32)

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        s = self.data_list[idx]
        num_parts = int(s["num_parts"])
        rot_mats, _ = _draw_rotations(num_parts, rng)
        pts, _, _ = native.augment_parts_cpu(s["part_pcs_gt"][:num_parts], rot_mats,
                                            normalize=False)
        cur = _pad(pts, self.max_num_part)
        scale = np.max(np.abs(cur), axis=(1, 2), keepdims=True)
        scale[scale == 0] = 1
        return {
            "part_pcs": (cur / scale).astype(np.float32),
            "part_valids": _pad(s["part_valids"][:, None], self.max_num_part)[:, 0],
            "num_parts": num_parts,
            "data_id": int(s["data_id"]),
        }


class DenoiserDataset:
    """Whole-shape random rotation, recentre on the reference part, per-part recentre and
    random rotation giving the GT 7-DoF pose, per-part max-abs normalisation capturing
    part_scale, pad to ``max_num_part`` (reference denoiser/dataset/dataset.py:163-274).
    ``train`` adds the multi-reference-part curriculum; ``test`` adds the dense matching
    arrays of the engine."""

    def __init__(
        self,
        data_dir: str,
        mode: str = "test",  # train | val | test
        matching_data_path: str | None = None,
        max_num_part: int = 20,
        multiple_ref_parts: bool = True,
        overfit: int = -1,
        max_area_points_per_part: int | None = None,
        max_corr: int = 128,
        max_edges_dense: int = 380,
    ):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode must be train, val or test, got {mode!r}")
        if mode == "test" and matching_data_path is None:
            raise ValueError("test mode needs matching_data_path")
        self.mode = mode
        self.max_num_part = max_num_part
        self.multiple_ref_parts = multiple_ref_parts
        # forward-process arrays of the curriculum's perturbation (dataset.py:263-271)
        abar = np.cumprod(1.0 - piecewise_betas().astype(np.float64))
        self._sqrt_abar = np.sqrt(abar).astype(np.float32)
        self._sqrt_1m_abar = np.sqrt(1.0 - abar).astype(np.float32)
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

    def _curriculum_ref_parts(self, d: dict, rng: np.random.Generator) -> dict:
        """Multi-reference-part sampling and its noise perturbation (dataset.py:228-271):
        with probability 1/2 (never for 2 parts), some parts connected to the reference
        part become references too, their poses noised to a timestep below 50."""
        if d["num_parts"] == 2 or rng.random() < 0.5:
            return d
        ref_part = d["ref_part"]
        ref_idx = np.where(ref_part)[0]
        connect = np.where(d["graph"][ref_idx, :])[1]
        larger = [p for p in connect if d["part_scale"][p] > 0.05]
        if not larger:
            return d
        # the reference draws the count from the larger parts and the parts from all
        # connected ones; kept as it is
        sample_num = rng.integers(0, len(larger))
        sampled = rng.choice(connect, sample_num, replace=False)
        ref_part[sampled] = True
        t = int(rng.integers(0, 50))
        for key in ("part_trans", "part_rots"):
            x = d[key][sampled]
            noise = rng.standard_normal(x.shape).astype(np.float32)
            d[key][sampled] = self._sqrt_abar[t] * x + self._sqrt_1m_abar[t] * noise
        return d

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
        pts, centroids, _ = native.augment_parts_cpu(part_pcs_final[:num_parts], rot_mats,
                                                     normalize=False)
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
        elif self.mode == "train" and self.multiple_ref_parts:
            d = self._curriculum_ref_parts(d, rng)
        return d


class VerifierDataset:
    """Verifier files (``cls_gt``, ``edge_features [E, 6]``, ``edge_indices [E, 2]``) padded
    to ``max_edges`` with ``edge_valids``; the sorted files split 80/20 into train and val.
    ``get`` divides each edge's 6 histogram bins by its point count and appends the count
    as the 7th feature (reference verifier/dataset/dataset.py)."""

    def __init__(self, data_dir: str, mode: str = "train", overfit: int = -1,
                 max_edges: int = MAX_EDGES):
        self.max_edges = max_edges
        files = sorted(f for f in os.listdir(data_dir) if f.endswith(".npz"))
        if overfit != -1:
            files = files[:overfit]
        cut = int(0.8 * len(files))
        files = files[:cut] if mode == "train" else files[cut:]
        self.data_list = []
        for f in files:
            data = np.load(os.path.join(data_dir, f))
            num_edges = data["edge_indices"].shape[0]
            edge_valids = np.zeros(max_edges, np.float32)
            edge_valids[:num_edges] = 1
            self.data_list.append({
                "cls_gt": _pad(data["cls_gt"].astype(np.float32)[:, None], max_edges)[:, 0],
                "edge_features": _pad(data["edge_features"].astype(np.float32), max_edges),
                "edge_indices": _pad(data["edge_indices"].astype(np.float32), max_edges)
                .astype(np.int64),
                "edge_valids": edge_valids,
                "num_edges": num_edges,
            })

    def __len__(self):
        return len(self.data_list)

    def get(self, idx: int, rng: np.random.Generator) -> dict:
        d = dict(self.data_list[idx])
        feats = d["edge_features"]
        num_points = feats.sum(axis=1)
        feats = feats / np.where(num_points == 0, 1, num_points)[:, None]
        d["edge_features"] = np.concatenate([feats, num_points[:, None]], axis=1)
        return d
