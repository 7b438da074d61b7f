"""Synthetic Breaking-Bad-style fixture generator.

A copy of ``puzzlefusion_plusplus_tpu/data/synthetic.py`` (numpy and scipy only), kept so that
the port imports nothing from the JAX package; the same seed writes the same files.

The real Breaking Bad dataset (meshes) and the released Jigsaw matching artifacts are external
downloads in the reference (docs/data_preparation.md). For hermetic tests/benchmarks we generate
synthetic fractured shapes with the exact same .npz schemas the reference pipeline produces and
consumes:

  * ``pc_data`` shape files (generate_pc_data.py:31-41): data_id, part_valids [20], num_parts,
    mesh_file_path, graph [20, 20], category, part_pcs_gt [20, 1000, 3], ref_part [20].
  * ``matching_data`` files (Jigsaw_matching/model/modules/matching_base_model.py:614-640):
    edges [E, 2], correspondence (per-edge [K, 2] local critical-point index pairs), gt_pcs
    [N_sum, 3] area-sampled cloud, critical_pcs_idx [N_sum], n_pcs [P], n_critical_pcs [P].
  * ``verifier_data`` files (verifier/dataset/dataset.py:50-53): cls_gt [E], edge_features
    [E, 6] CD-histogram counts, edge_indices [E, 2].

Fracture model (round 3, Breaking-Bad realism): real pc_data samples the SURFACE of each
mesh fragment (reference generate_pc_data.py:11-47 area-weighted triangle sampling), so each
fragment cloud is a hollow shell: a patch of the object's outer surface plus one irregular
fracture face per contact. We reproduce that with a noisy power diagram: random solids
(ellipsoid / box / cylinder) are partitioned by cells ``F_i(x) = ||x - s_i|| - r_i + n_i(x)``
where ``n_i`` is a band-limited random field — the ``n_i`` displacement makes fracture
surfaces wavy and non-convex (like physical fragmentation), ``r_i`` biases fragment sizes.
Fragment clouds are assembled from (a) outer-surface samples assigned by argmin F and
(b) interface samples (volume points where the two smallest cell fields nearly tie), split
randomly between the two touching fragments — fragments share true, irregular contact
surfaces, so fracture-surface correspondences and chamfer-histogram verifier features behave
like the real data. Adjacency comes from interface point counts.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

CD_BIN_EDGES = np.array([0.0, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 100.0])


def _make_solid(rng: np.random.Generator) -> dict:
    """A random solid with an inside() predicate and an outer-surface sampler.

    Max extent ~[-0.5, 0.5] (matches the reference's normalized-object scale)."""
    kind = int(rng.integers(0, 3))
    if kind == 0:  # ellipsoid
        radii = rng.uniform(0.25, 0.5, size=3)

        def inside(x):
            return np.sum((x / radii) ** 2, axis=-1) <= 1.0

        def sample_surface(n, r):
            # area-weighted: naive u*radii oversamples high-curvature poles; for direction
            # u the area element scales by g(u) = |(u1*b*c, u2*a*c, u3*a*b)|, so rejection
            # with prob g/g_max gives uniform-by-area density (exact, like box/cylinder)
            w = np.array([radii[1] * radii[2], radii[0] * radii[2], radii[0] * radii[1]])
            g_max = w.max()
            out = []
            got = 0
            while got < n:
                u = r.normal(size=(2 * (n - got) + 16, 3))
                u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-9)
                g = np.sqrt(((u * w) ** 2).sum(axis=1))
                u = u[r.random(len(u)) * g_max < g]
                out.append(u)
                got += len(u)
            return (np.concatenate(out)[:n] * radii).astype(np.float64)

    elif kind == 1:  # box
        half = rng.uniform(0.2, 0.5, size=3)

        def inside(x):
            return np.all(np.abs(x) <= half, axis=-1)

        def sample_surface(n, r):
            areas = np.array([half[1] * half[2], half[0] * half[2], half[0] * half[1]])
            face_axis = r.choice(3, size=n, p=areas / areas.sum())
            sign = r.choice([-1.0, 1.0], size=n)
            pts = r.uniform(-1.0, 1.0, size=(n, 3)) * half
            pts[np.arange(n), face_axis] = sign * half[face_axis]
            return pts

    else:  # cylinder along z
        rad = rng.uniform(0.2, 0.45)
        h = rng.uniform(0.25, 0.5)

        def inside(x):
            return (x[..., 0] ** 2 + x[..., 1] ** 2 <= rad * rad) & (
                np.abs(x[..., 2]) <= h
            )

        def sample_surface(n, r):
            a_side = 2 * np.pi * rad * 2 * h
            a_caps = 2 * np.pi * rad * rad
            n_side = int(n * a_side / (a_side + a_caps))
            theta = r.uniform(0, 2 * np.pi, size=n)
            pts = np.empty((n, 3))
            pts[:n_side, 0] = rad * np.cos(theta[:n_side])
            pts[:n_side, 1] = rad * np.sin(theta[:n_side])
            pts[:n_side, 2] = r.uniform(-h, h, size=n_side)
            n_cap = n - n_side
            rr = rad * np.sqrt(r.uniform(0, 1, size=n_cap))
            pts[n_side:, 0] = rr * np.cos(theta[n_side:])
            pts[n_side:, 1] = rr * np.sin(theta[n_side:])
            pts[n_side:, 2] = r.choice([-h, h], size=n_cap)
            return pts

    return {"inside": inside, "sample_surface": sample_surface}


def _sample_volume(solid: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """n uniform points inside the solid (rejection from the bounding box)."""
    out = []
    got = 0
    while got < n:
        cand = rng.uniform(-0.5, 0.5, size=(int(n * 2.5), 3))
        cand = cand[solid["inside"](cand)]
        out.append(cand)
        got += len(cand)
    return np.concatenate(out, axis=0)[:n]


def _cell_fields(
    rng: np.random.Generator, num_parts: int, n_waves: int = 4,
    noise_amp: tuple = (0.015, 0.05), size_bias: float = 0.1,
):
    """Noisy power-diagram cell fields: returns field(x [n,3], seeds [P,3]) -> [n,P].

    F_i(x) = ||x - s_i|| - r_i + n_i(x) with n_i a sum of random sinusoids (band-limited
    noise, wavelengths ~0.12-0.5 on the unit-scale solid) — the displacement term carves
    wavy, non-convex fracture surfaces instead of flat Voronoi bisectors."""
    P, W = num_parts, n_waves
    k = rng.uniform(2.0, 8.0, size=(P, W, 3)) * rng.choice([-1.0, 1.0], size=(P, W, 3))
    phase = rng.uniform(0, 2 * np.pi, size=(P, W))
    amp = rng.uniform(0.5, 1.0, size=(P, W))
    amp *= (rng.uniform(*noise_amp, size=(P, 1))) / amp.sum(axis=1, keepdims=True)
    r_i = rng.uniform(0.0, size_bias, size=P)

    def field(x, seeds):
        d = np.linalg.norm(x[:, None, :] - seeds[None], axis=-1)  # [n, P]
        ph = 2 * np.pi * np.einsum("nd,pwd->npw", x, k) + phase[None]
        return d - r_i[None] + np.einsum("pw,npw->np", amp, np.sin(ph))

    return field


def _resample(pts: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    idx = rng.choice(len(pts), n, replace=len(pts) < n)
    return pts[idx]


def fracture_shape(
    rng: np.random.Generator,
    num_parts: int,
    n_points: int = 1000,
    n_dense: int = 40000,
    interface_tau: float = 0.025,
) -> dict:
    """Fracture a random solid into ``num_parts`` hollow surface-sampled fragments.

    Returns per-fragment surface point pools + adjacency graph + reference part (largest
    extent, as in reference vqvae/dataset/dataset.py:200-204). Fragment pools mix outer-shell
    samples with fracture-interface samples (|F_(2) - F_(1)| < tau slab, randomly split
    between the two touching cells) — the hollow-shell point distribution the real
    area-weighted mesh sampling produces (generate_pc_data.py:11-47)."""
    n_shell = max(4000, n_dense * 3 // 20)
    min_pool = max(60, n_points // 10)
    for _ in range(30):  # rejection: every fragment needs enough points + connected graph
        solid = _make_solid(rng)
        vol = _sample_volume(solid, rng, n_dense)
        seeds = vol[rng.choice(len(vol), num_parts, replace=False)]
        field = _cell_fields(rng, num_parts)
        shell = solid["sample_surface"](n_shell, rng)

        f_vol = field(vol, seeds)  # [n_dense, P]
        f_shell = field(shell, seeds)  # [n_shell, P]
        shell_label = np.argmin(f_shell, axis=1)

        two = np.argpartition(f_vol, 1, axis=1)[:, :2]  # two smallest cell fields
        f12 = np.take_along_axis(f_vol, two, axis=1)
        order = np.argsort(f12, axis=1)
        two = np.take_along_axis(two, order, axis=1)
        gap = np.abs(f12[:, 1] - f12[:, 0])
        near = gap < interface_tau  # thin slab around each fracture surface
        iface_pts = vol[near]
        iface_pair = np.sort(two[near], axis=1)  # [m, 2] (lo, hi)
        # split each interface point randomly between its two fragments (each real fragment
        # carries its own independent sampling of the shared face)
        side = rng.random(len(iface_pts)) < 0.5
        iface_label = np.where(side, iface_pair[:, 0], iface_pair[:, 1])

        pools = [
            np.concatenate([shell[shell_label == i], iface_pts[iface_label == i]], axis=0)
            for i in range(num_parts)
        ]
        counts = np.array([len(p) for p in pools])

        # adjacency from interface point counts (a real shared fracture face)
        graph = np.zeros((num_parts, num_parts), dtype=bool)
        if len(iface_pair):
            pair_ids, pair_counts = np.unique(
                iface_pair[:, 0] * num_parts + iface_pair[:, 1], return_counts=True
            )
            for pid, c in zip(pair_ids, pair_counts):
                if c >= 20:
                    i, j = divmod(int(pid), num_parts)
                    graph[i, j] = graph[j, i] = True

        # connectivity check (real fractured objects are connected)
        seen = {0}
        frontier = [0]
        while frontier:
            i = frontier.pop()
            for j in np.where(graph[i])[0]:
                if j not in seen:
                    seen.add(int(j))
                    frontier.append(int(j))
        if counts.min() >= min_pool and len(seen) == num_parts:
            break
    else:
        # 30 rejections (high part counts on small solids): repair the last attempt instead
        # of emitting it unchecked — an empty pool would crash _resample and a disconnected
        # graph breaks the connected-object property downstream consumers assume.
        for i in range(num_parts):
            deficit = min_pool - len(pools[i])
            if deficit > 0:
                # top up from the volume points nearest cell i's field (duplication across
                # parts is fine: each fragment carries its own sampling of shared regions)
                take = np.argpartition(f_vol[:, i], deficit)[:deficit]
                pools[i] = np.concatenate([pools[i], vol[take]], axis=0)
        while len(seen) < num_parts:  # bridge components via the closest seed pair
            sl = sorted(seen)
            out_ = [j for j in range(num_parts) if j not in seen]
            d = ((seeds[sl][:, None, :] - seeds[out_][None, :, :]) ** 2).sum(-1)
            a, b = divmod(int(d.argmin()), len(out_))
            si, oj = sl[a], out_[b]
            graph[si, oj] = graph[oj, si] = True
            seen.add(oj)
            frontier = [oj]
            while frontier:  # absorb anything already linked to the bridged node
                k_ = frontier.pop()
                for m in np.where(graph[k_])[0]:
                    if m not in seen:
                        seen.add(int(m))
                        frontier.append(int(m))
    dense_parts = pools

    part_pcs = np.stack([_resample(p, n_points, rng) for p in dense_parts])  # [P, N, 3]

    extents = np.array([p.max(0) - p.min(0) for p in dense_parts]).max(axis=1)
    ref_part = np.zeros(num_parts, dtype=bool)
    ref_part[np.argmax(extents)] = True

    return {
        "dense_parts": dense_parts,
        "part_pcs_gt": part_pcs.astype(np.float32),
        "graph": graph,
        "ref_part": ref_part,
        "num_parts": num_parts,
    }


def _pad(data: np.ndarray, max_p: int) -> np.ndarray:
    out = np.zeros((max_p,) + data.shape[1:], dtype=np.float32)
    out[: data.shape[0]] = data
    return out


def make_pc_data_npz(shape: dict, data_id: int, max_num_part: int = 20) -> dict:
    """Assemble the pc_data .npz field dict (generate_pc_data.py:31-41 schema)."""
    P = shape["num_parts"]
    part_valids = np.zeros(max_num_part, np.float32)
    part_valids[:P] = 1
    return {
        "data_id": data_id,
        "part_valids": part_valids,
        "num_parts": P,
        "mesh_file_path": f"synthetic/{data_id:05d}",
        "graph": _pad_square(shape["graph"], max_num_part),
        "category": "synthetic",
        "part_pcs_gt": _pad(shape["part_pcs_gt"], max_num_part),
        "ref_part": _pad(shape["ref_part"].astype(np.float32), max_num_part).astype(bool),
    }


def _pad_square(g: np.ndarray, max_p: int) -> np.ndarray:
    out = np.zeros((max_p, max_p), dtype=g.dtype)
    out[: g.shape[0], : g.shape[1]] = g
    return out


def make_matching_data_npz(
    shape: dict,
    rng: np.random.Generator,
    total_area_points: int = 5000,
    contact_threshold: float = 0.04,
    max_corr: int = 128,
) -> dict:
    """Synthetic Jigsaw matching artifact (matching_base_model.py:614-640 schema).

    Area sampling is count-proportional with a min of 30 points/fragment
    (all_piece_matching_dataset.py:164-193); critical points are points near another fragment;
    correspondences are nearest-neighbor pairs across each contact within the threshold.
    """
    P = shape["num_parts"]
    dense_parts = shape["dense_parts"]
    counts = np.array([len(p) for p in dense_parts], dtype=np.float64)
    n_pcs = np.maximum(30, (counts / counts.sum() * total_area_points).astype(np.int64))
    while n_pcs.sum() > total_area_points:
        n_pcs[np.argmax(n_pcs)] -= 1

    area_parts = [_resample(dense_parts[i], int(n_pcs[i]), rng) for i in range(P)]
    gt_pcs = np.concatenate(area_parts, axis=0).astype(np.float32)

    # critical points: within contact_threshold of any adjacent fragment's area points
    # (cKDTree NN queries replace the dense [ni, nj] distance matrices — same semantics,
    # dominates dataset generation time otherwise)
    from scipy.spatial import cKDTree

    trees = [cKDTree(p) for p in area_parts]
    critical_local_idx = []
    n_critical = np.zeros(P, dtype=np.int64)
    for i in range(P):
        near = np.zeros(len(area_parts[i]), dtype=bool)
        for j in range(P):
            if i == j or not shape["graph"][i, j]:
                continue
            dij, _ = trees[j].query(area_parts[i], k=1)
            near |= dij < contact_threshold
        idx = np.where(near)[0]
        critical_local_idx.append(idx)
        n_critical[i] = len(idx)

    # flat critical_pcs_idx: per part, local indices at offset prefix(n_pcs) (dataset.py:55-79)
    critical_pcs_idx = np.zeros(int(n_pcs.sum()), dtype=np.int64)
    off = 0
    for i in range(P):
        critical_pcs_idx[off : off + n_critical[i]] = critical_local_idx[i]
        off += int(n_pcs[i])

    # edges both directions per adjacent pair + NN correspondences between critical sets
    edges, corrs = [], []
    for i in range(P):
        for j in range(P):
            if i >= j or not shape["graph"][i, j]:
                continue
            ci = area_parts[i][critical_local_idx[i]]
            cj = area_parts[j][critical_local_idx[j]]
            if len(ci) == 0 or len(cj) == 0:
                continue
            d_nn, nn_j = cKDTree(cj).query(ci, k=1)
            keep = d_nn < contact_threshold
            src = np.where(keep)[0]
            if len(src) == 0:
                continue
            if len(src) > max_corr:
                src = rng.choice(src, max_corr, replace=False)
            pair = np.stack([src, nn_j[src]], axis=1).astype(np.int64)  # [K, 2]
            # store (larger, smaller) so the upper-triangle read in the agglomeration loop
            # (auto_aggl.py:185-193: writes [edges[i,1], edges[i,0]]) sees the features
            edges.append([j, i])
            corrs.append(pair)
            edges.append([i, j])
            corrs.append(pair[:, ::-1].copy())

    return {
        "edges": np.asarray(edges, dtype=np.int64).reshape(-1, 2),
        "correspondence": np.asarray(corrs, dtype=object),
        "gt_pcs": gt_pcs,
        "critical_pcs_idx": critical_pcs_idx,
        "n_pcs": n_pcs,
        "n_critical_pcs": n_critical,
    }


def cd_histogram(src: np.ndarray, tgt: np.ndarray) -> np.ndarray:
    """Per-point bidirectional squared-NN-distance histogram -> 6 bin counts.

    Mirrors auto_aggl.py:184-193 + _make_cd_to_bins:385-389: chamferdist with
    point_reduction=None on equal-length sets returns index-aligned fwd+bwd per-point sums;
    bucketize(right=True) against [0, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 100], keep bins 1..6.
    """
    if len(src) == 0:
        return np.zeros(6, np.int64)
    d = np.sum((src[:, None, :] - tgt[None]) ** 2, axis=-1)
    per_point = d.min(axis=1) + d.min(axis=0)  # equal K: index-aligned sum
    bin_idx = np.searchsorted(CD_BIN_EDGES, per_point, side="left")
    counts = np.bincount(bin_idx, minlength=8)
    return counts[1:7]


def make_verifier_data_npz(
    shape: dict, matching: dict, rng: np.random.Generator
) -> dict:
    """Synthetic verifier training sample (verifier/dataset/dataset.py:50-53 schema).

    For every matching edge, poses the two fragments either consistently (near-GT relative pose,
    label 1) or with a random relative perturbation (label 0), and records the CD histogram of
    the matched correspondence points under those poses.
    """
    n_pcs = matching["n_pcs"]
    offsets = np.concatenate([[0], np.cumsum(n_pcs)])
    gt_pcs = matching["gt_pcs"]
    edges = matching["edges"]
    corrs = matching["correspondence"]
    n_critical = matching["n_critical_pcs"]
    critical_idx = matching["critical_pcs_idx"]

    seen = set()
    cls_gt, edge_features, edge_indices = [], [], []
    for e in range(len(edges)):
        # corr[:, 0] indexes the critical set of edges[e, 1]; corr[:, 1] that of edges[e, 0]
        # (reference auto_aggl.py:185-193 / node_merge_utils.py:62-89 argument order)
        b, a = int(edges[e, 0]), int(edges[e, 1])
        lo, hi = min(a, b), max(a, b)
        if (lo, hi) in seen:
            continue
        seen.add((lo, hi))
        pc_a = gt_pcs[offsets[a] : offsets[a + 1]]
        pc_b = gt_pcs[offsets[b] : offsets[b + 1]]
        crit_a = pc_a[critical_idx[offsets[a] : offsets[a] + n_critical[a]]]
        crit_b = pc_b[critical_idx[offsets[b] : offsets[b] + n_critical[b]]]
        corr = np.asarray(corrs[e]).astype(np.int64).reshape(-1, 2)
        src = crit_a[corr[:, 0]]
        tgt = crit_b[corr[:, 1]]
        positive = rng.random() < 0.5
        if positive:
            jitter = rng.normal(0, 2e-3, size=3)
            tgt_posed = tgt + jitter
        else:
            angle = rng.uniform(0.3, np.pi)
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            K = np.array(
                [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
            )
            rot = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K
            tgt_posed = tgt @ rot.T + rng.normal(0, 0.2, size=3)
        cls_gt.append(1 if positive else 0)
        edge_features.append(cd_histogram(src, tgt_posed))
        edge_indices.append([lo, hi])

    return {
        "cls_gt": np.asarray(cls_gt, np.int64),
        "edge_features": np.asarray(edge_features, np.float32).reshape(-1, 6),
        "edge_indices": np.asarray(edge_indices, np.int64).reshape(-1, 2),
    }


def generate_dataset(
    out_dir: str,
    num_shapes: int = 32,
    seed: int = 0,
    min_parts: int = 2,
    max_parts: int = 8,
    n_points: int = 1000,
    with_matching: bool = True,
    with_verifier: bool = True,
    split: str = "train",
) -> None:
    """Write a full synthetic dataset tree: pc_data/{split}, matching_data, verifier_data."""
    pc_dir = os.path.join(out_dir, "pc_data", split)
    match_dir = os.path.join(out_dir, "matching_data")
    verif_dir = os.path.join(out_dir, "verifier_data")
    os.makedirs(pc_dir, exist_ok=True)
    if with_matching:
        os.makedirs(match_dir, exist_ok=True)
    if with_verifier:
        os.makedirs(verif_dir, exist_ok=True)

    # zlib.crc32, NOT hash(): str hashes are PYTHONHASHSEED-salted per process, which made
    # "identical seed" datasets differ between processes (flaky tests, unreproducible runs)
    rng = np.random.default_rng((seed, zlib.crc32(split.encode())))
    base = 0 if split == "train" else 10_000
    # dense-volume budget scales with the cloud resolution asked for: test fixtures at
    # n_points ~100 keep generation fast, production n_points=1000 gets the full 40k
    n_dense = int(np.clip(n_points * 40, 8000, 40000))
    for s in range(num_shapes):
        data_id = base + s
        num_parts = int(rng.integers(min_parts, max_parts + 1))
        shape = fracture_shape(rng, num_parts, n_points=n_points, n_dense=n_dense)
        np.savez(
            os.path.join(pc_dir, f"{data_id:05d}.npz"), **make_pc_data_npz(shape, data_id)
        )
        if with_matching or with_verifier:
            matching = make_matching_data_npz(shape, rng)
        if with_matching:
            np.savez(os.path.join(match_dir, f"{data_id}.npz"), **matching)
        if with_verifier:
            np.savez(
                os.path.join(verif_dir, f"{data_id:05d}.npz"),
                **make_verifier_data_npz(shape, matching, rng),
            )
