"""The benchmark's traffic: shape sets made from a seed, and the engine's batches built from
them.

Every seed gets the same multiset of part counts (``multiset``), in an order drawn from the
seed, and its own geometry: so two seeds ask for the same work. A workload file gives the
counts as ``part_draw`` (the synthetic generator's own draw, below) or lists them as
``part_counts``, repeated ``repeats`` times. Each
shape is drawn from its own generator, ``default_rng((word(seed), 1, i))``, so that a pool of
processes makes the set in parallel and gets what one process would.

Engine samples are built here, not by the program's dataset: ``test_sample`` is a frozen
copy of ``DenoiserDataset.get`` in test mode (whole-shape rotation, recentring on the
reference part, per-part recentring and rotation giving the GT pose, per-part max-abs
normalisation, the area clouds moved to each part's frame, the dense matching arrays), with
the per-part augmentation in numpy. The program and the reference are handed the same arrays.
"""

from __future__ import annotations

import multiprocessing
import os

import numpy as np
from scipy.spatial.transform import Rotation

from pfpp_bench.seeds import word
from pfpp_bench.traffic import synthetic

# the engine's input arrays (``inference/run.py::SAMPLE_KEYS``)
SAMPLE_KEYS = (
    "part_pcs", "part_trans", "part_rots", "part_scale", "part_valids", "ref_part",
    "num_parts", "area_pts", "n_area", "match_edges", "match_edge_valid",
    "corr_src", "corr_tgt", "corr_count",
)
PART_KEYS = ("part_pcs", "part_trans", "part_rots", "part_scale", "part_valids", "ref_part",
             "area_pts", "n_area")
EDGE_KEYS = ("match_edges", "match_edge_valid", "corr_src", "corr_tgt", "corr_count")
N_DENSE = 40000  # the generator's dense-volume budget at 1000 points a part


def multiset(traffic: dict) -> np.ndarray:
    """The set's part counts, in a fixed order.

    ``part_draw`` {"low", "high", "shapes"}: the program's synthetic generator draws each
    shape's part count as ``rng.integers(low, high + 1)``, uniform over low..high
    (``data/synthetic.py::generate_dataset``). The set takes that distribution's quantiles
    at (i + 0.5) / shapes, one a shape, so that every seed asks for the same counts, each
    value as often as the draw would give it on average (within one)."""
    if ("part_draw" in traffic) == ("part_counts" in traffic):
        raise ValueError("traffic needs one of part_draw and part_counts")
    if "part_draw" in traffic:
        d = traffic["part_draw"]
        n, width = int(d["shapes"]), int(d["high"]) - int(d["low"]) + 1
        return int(d["low"]) + ((np.arange(n) + 0.5) * width / n).astype(np.int64)
    return np.tile(np.asarray(traffic["part_counts"], np.int64), traffic.get("repeats", 1))


def part_counts(traffic: dict, seed: int) -> np.ndarray:
    """The set's part counts in the seed's order."""
    counts = multiset(traffic)
    return counts[np.random.default_rng((word(seed), 0)).permutation(len(counts))]


def _make_shape(args) -> dict:
    """Shape ``i`` of the set: its fracture, and its matching record when asked."""
    seed, i, num_parts, n_points, with_matching = args
    rng = np.random.default_rng((word(seed), 1, i))
    shape = synthetic.fracture_shape(rng, int(num_parts), n_points=n_points, n_dense=N_DENSE)
    out = {"pc": synthetic.make_pc_data_npz(shape, i)}
    if with_matching:
        out["matching"] = synthetic.make_matching_data_npz(shape, rng)
    return out


def _write_shape(args) -> str:
    """Shape ``i`` written as a pc_data file under ``out_dir``."""
    out_dir, seed, i, num_parts, n_points = args
    rec = _make_shape((seed, i, num_parts, n_points, False))["pc"]
    path = os.path.join(out_dir, f"{i:05d}.npz")
    np.savez(path, **rec)
    return path


class Pending:
    """Jobs mapped over a pool of spawned processes, started at once; ``get`` waits for
    the results, in order, and closes the pool. With one worker they run in ``get``."""

    def __init__(self, fn, jobs: list, workers: int):
        self.fn, self.jobs, self.pool, self.res = fn, jobs, None, None
        if workers > 1 and len(jobs) > 1:
            ctx = multiprocessing.get_context("spawn")
            self.pool = ctx.Pool(min(workers, len(jobs)))
            self.res = self.pool.map_async(fn, jobs, chunksize=1)

    def get(self) -> list:
        if self.pool is None:
            return [self.fn(j) for j in self.jobs]
        try:
            return self.res.get()
        finally:
            self.pool.close()
            self.pool.join()


def make_shapes(traffic: dict, seed: int, points: int, workers: int) -> Pending:
    """Every shape of the set, ``points`` a part, with its matching record, in the seed's
    order: started in the background, ``get()`` them."""
    counts = part_counts(traffic, seed)
    jobs = [(seed, i, int(n), points, True) for i, n in enumerate(counts)]
    return Pending(_make_shape, jobs, workers)


def write_train_set(traffic: dict, seed: int, points: int, out_dir: str,
                    workers: int) -> Pending:
    """The training set as pc_data files under ``out_dir``, in the seed's order, ``points``
    a part: started in the background, ``get()`` the paths."""
    os.makedirs(out_dir, exist_ok=True)
    counts = part_counts(traffic, seed)
    jobs = [(out_dir, seed, i, int(n), points) for i, n in enumerate(counts)]
    return Pending(_write_shape, jobs, workers)


def _pad(data: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,) + tuple(data.shape[1:]), dtype=np.float32)
    m = min(n, data.shape[0])
    out[:m] = data[:m]
    return out


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    return Rotation.random(random_state=rng).as_matrix()


def test_sample(rec: dict, seed: int, i: int, max_parts: int, area_pad: int,
                max_corr: int = 128, max_edges: int = 380) -> dict:
    """The engine's arrays of shape ``i`` (a frozen copy of the program's test-mode dataset
    item; the module note), augmented from ``default_rng((word(seed), 2, i))``."""
    rng = np.random.default_rng((word(seed), 2, i))
    s, m = rec["pc"], rec["matching"]
    n = int(s["num_parts"])
    gt = s["part_pcs_gt"][:n]
    ref = s["ref_part"].copy()

    # whole-shape rotation, recentred on the reference part
    rot = _random_rotation(rng)
    flat = (rot @ gt.reshape(-1, 3).T).T
    pose_q = Rotation.from_matrix(rot.T).as_quat()[[3, 0, 1, 2]]
    pcs = flat.reshape(n, -1, 3)
    ref_idx = int(np.where(ref[:n])[0].item())
    pose_t = pcs[ref_idx].mean(axis=0)
    pcs = pcs - pose_t

    # per-part recentring and rotation: the GT pose of each part
    mats = np.empty((n, 3, 3), np.float32)
    quats = np.empty((n, 4), np.float32)
    for p in range(n):
        mat = _random_rotation(rng)
        mats[p] = mat
        quats[p] = Rotation.from_matrix(mat.T).as_quat()[[3, 0, 1, 2]]
    pcs = pcs.astype(np.float32)
    centroids = pcs.mean(axis=1)
    pts = np.einsum("pij,pnj->pni", mats, pcs - centroids[:, None, :]).astype(np.float32)
    P = max_parts
    cur_pts, cur_quat, cur_trans = _pad(pts, P), _pad(quats, P), _pad(centroids, P)

    # the area clouds in the augmented frame, each moved to its part's local frame
    anchored = Rotation.from_quat(pose_q[[1, 2, 3, 0]]).inv().apply(m["gt_pcs"]) - pose_t
    n_pcs = m["n_pcs"].astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(n_pcs)])
    area_pts = np.zeros((P, area_pad, 3), np.float32)
    n_area = np.zeros(P, np.int32)
    for p in range(n):
        k = int(n_pcs[p])
        if k > area_pad:
            raise ValueError(f"{k} area points exceed the pad {area_pad}")
        c = anchored[offsets[p]:offsets[p + 1]] - cur_trans[p]
        area_pts[p, :k] = Rotation.from_quat(cur_quat[p][[1, 2, 3, 0]]).inv().apply(c)
        n_area[p] = k

    scale = np.max(np.abs(cur_pts), axis=(1, 2), keepdims=True)
    scale[scale == 0] = 1

    # the dense matching arrays: corr[:, 0] indexes the critical set of edges[e, 1]
    crit = m["critical_pcs_idx"].astype(np.int64)
    n_crit = m["n_critical_pcs"].astype(np.int64)
    edges = m["edges"].astype(np.int64).reshape(-1, 2)
    corrs = m["correspondence"]
    match_edges = np.zeros((max_edges, 2), np.int32)
    edge_valid = np.zeros(max_edges, bool)
    corr_src = np.zeros((max_edges, max_corr), np.int32)
    corr_tgt = np.zeros((max_edges, max_corr), np.int32)
    corr_count = np.zeros(max_edges, np.int32)
    for e in range(min(len(edges), max_edges)):
        b, a = int(edges[e, 0]), int(edges[e, 1])
        corr = np.asarray(corrs[e]).astype(np.int64).reshape(-1, 2)
        k = min(len(corr), max_corr)
        crit_a = crit[offsets[a]:offsets[a] + n_crit[a]]
        crit_b = crit[offsets[b]:offsets[b] + n_crit[b]]
        match_edges[e] = (b, a)
        edge_valid[e] = True
        corr_src[e, :k] = crit_a[corr[:k, 0]]
        corr_tgt[e, :k] = crit_b[corr[:k, 1]]
        corr_count[e] = k

    return {
        "part_pcs": (cur_pts / scale).astype(np.float32),
        "part_trans": cur_trans, "part_rots": cur_quat,
        "part_scale": scale.squeeze(-1).astype(np.float32),
        "part_valids": _pad(s["part_valids"][:, None], P)[:, 0],
        "ref_part": _pad(ref.astype(np.float32)[:, None], P)[:, 0].astype(bool),
        "num_parts": np.int64(n), "area_pts": area_pts, "n_area": n_area,
        "match_edges": match_edges, "match_edge_valid": edge_valid,
        "corr_src": corr_src, "corr_tgt": corr_tgt, "corr_count": corr_count,
    }


def bucket(max_parts: int, multiple: int, cap: int) -> int:
    """The smallest multiple of ``multiple`` that holds ``max_parts``, within [multiple, cap]."""
    return max(multiple, min(-(-int(max_parts) // multiple) * multiple, cap))


def batch_of(samples: list[dict], multiple: int, cap: int) -> dict:
    """Stack samples and slice them to their bucket's part pad, as the program's serving
    loop does (``data/bucketing.py::slice_batch_parts``)."""
    out = {k: np.stack([np.asarray(s[k]) for s in samples]) for k in SAMPLE_KEYS}
    P = bucket(int(out["num_parts"].max()), multiple, cap) if multiple else cap
    E = P * (P - 1)
    if out["match_edge_valid"][:, E:].any():
        raise ValueError("valid match edges beyond the bucket's edge budget")
    for k in PART_KEYS:
        out[k] = out[k][:, :P]
    for k in EDGE_KEYS:
        out[k] = out[k][:, :E]
    return out


def engine_batches(traffic: dict, recs: list, seed: int, max_parts: int) -> list[dict]:
    """The engine's requests from the set's shapes (``make_shapes``): the samples in
    batches of ``batch``, sorted by part count when ``sort_by_parts`` (the program's serving
    order), else in the seed's order, each sliced to its bucket's pad."""
    samples = [test_sample(r, seed, i, max_parts, traffic["area_pad"])
               for i, r in enumerate(recs)]
    order = np.arange(len(samples))
    if traffic["sort_by_parts"]:
        order = np.argsort([int(s["num_parts"]) for s in samples], kind="stable")
    B = traffic["batch"]
    return [batch_of([samples[j] for j in order[i:i + B]], traffic["bucket_multiple"],
                     max_parts) for i in range(0, len(order), B)]
