"""Rigid alignment: weighted Horn/Kabsch, RANSAC and pose-graph global alignment (port of
``puzzlefusion_plusplus_tpu/matching/alignment.py``).

``weighted_horn``, ``transform_error`` and ``ransac_transform`` work on tensors;
``spanning_tree_alignment``, ``chordal_rotation_averaging`` and ``global_alignment`` are the
host (numpy) pose-graph solvers. The JAX package builds the spanning tree with networkx;
here it is Kruskal over a union-find followed by a breadth-first walk from node 0, in the
order networkx takes, so that tied weights pick the same tree:

* the graph keeps one edge per node pair: a later duplicate replaces the earlier one's
  weight and index only when its weight is lower, and keeps the pair's place;
* edges are listed as ``Graph.edges()`` lists them (by node, each node's neighbours in the
  order the pairs first appeared) and sorted stably by weight;
* the walk visits each node's tree neighbours in the order their edges joined the tree.
"""

from __future__ import annotations

import collections

import numpy as np
import torch


def weighted_horn(src: torch.Tensor, tgt: torch.Tensor, weights: torch.Tensor):
    """Least-squares rigid transform R @ src + t ~= tgt under per-point weights.
    src/tgt [..., N, 3], weights [..., N] -> (R [..., 3, 3], t [..., 3])."""
    w = weights[..., None]
    wsum = w.sum(-2, keepdim=True).clamp_min(1e-12)
    mu_s = (src * w).sum(-2, keepdim=True) / wsum
    mu_t = (tgt * w).sum(-2, keepdim=True) / wsum
    cov = torch.einsum("...ni,...nj->...ij", (src - mu_s) * w, tgt - mu_t)
    u, _, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    r = torch.einsum("...ij,...j,...kj->...ik", vt.transpose(-1, -2), d, u)  # V diag U^T
    t = mu_t[..., 0, :] - torch.einsum("...ij,...j->...i", r, mu_s[..., 0, :])
    return r, t


def transform_error(r, t, src, tgt):
    return torch.linalg.norm(torch.einsum("...ij,...nj->...ni", r, src) + t[..., None, :]
                             - tgt, dim=-1)


def ransac_transform(src: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor,
                     generator: torch.Generator | None = None, num_hypotheses: int = 128,
                     inlier_threshold: float = 0.02, hypotheses: torch.Tensor | None = None):
    """Correspondence RANSAC over compacted matches (valid ones first): 3-point Horn
    hypotheses, the one with most inliers, then a Horn refit on its inliers (on every valid
    match when it has fewer than 3). ``hypotheses`` [H, 3] int gives the point triples
    instead of drawing them from ``generator``. src/tgt [N, 3], valid [N] bool."""
    n_valid = valid.sum().clamp_min(1)
    if hypotheses is None:
        u = torch.rand((num_hypotheses, 3), generator=generator, device=src.device)
        hypotheses = (u * n_valid).long().clamp_max(n_valid - 1)
    hypotheses = hypotheses.long()
    rs, ts = weighted_horn(src[hypotheses], tgt[hypotheses],
                           torch.ones(hypotheses.shape, device=src.device))
    err = transform_error(rs, ts, src[None], tgt[None])  # [H, N]
    counts = ((err < inlier_threshold) & valid).sum(-1)
    best = torch.argmax(counts)  # the first of the best
    inliers = (err[best] < inlier_threshold) & valid
    w = torch.where(inliers.sum() >= 3, inliers, valid).to(src.dtype)
    return weighted_horn(src, tgt, w)


# ---------------------------------------------------------------- pose graph (host, numpy)


def _spanning_tree(n_nodes: int, edges: np.ndarray, uncertainty: np.ndarray) -> list[dict]:
    """The minimum spanning forest as networkx's Kruskal builds it -> the tree's adjacency,
    one insertion-ordered {neighbour: edge index} a node."""
    adj: list[dict] = [{} for _ in range(n_nodes)]  # neighbour -> [weight, edge index]
    for i, (a, b) in enumerate(edges):
        a, b, w = int(a), int(b), float(uncertainty[i])
        data = adj[a].get(b)
        if data is not None and data[0] <= w:
            continue
        if data is None:
            data = adj[a][b] = adj[b][a] = [0.0, 0]
        data[0], data[1] = w, i
    listed, seen = [], set()
    for n in range(n_nodes):  # Graph.edges() order
        listed += [(data[0], n, nbr, data[1]) for nbr, data in adj[n].items()
                   if nbr not in seen]
        seen.add(n)
    root = list(range(n_nodes))

    def find(x):
        while root[x] != x:
            root[x] = root[root[x]]
            x = root[x]
        return x

    tree: list[dict] = [{} for _ in range(n_nodes)]
    for _, u, v, i in sorted(listed, key=lambda e: e[0]):  # stable: ties keep their order
        ru, rv = find(u), find(v)
        if ru != rv:
            root[ru] = rv
            tree[u][v] = tree[v][u] = i
    return tree


def spanning_tree_alignment(n_nodes: int, edges: np.ndarray, transformations: np.ndarray,
                            uncertainty: np.ndarray) -> np.ndarray:
    """Global poses [n, 4, 4] accumulated along the minimum-uncertainty spanning tree from
    node 0 (the reference's MST fallback). edges[i] = (dst, src): ``transformations[i]``
    maps piece src into piece dst's frame; nodes 0 cannot reach keep the identity."""
    tree = _spanning_tree(n_nodes, edges, uncertainty)
    out = np.repeat(np.eye(4)[None], n_nodes, axis=0)
    seen, queue = {0}, collections.deque([0])
    while queue:  # breadth first, neighbours in the order their edges joined the tree
        parent = queue.popleft()
        for child, i in tree[parent].items():
            if child in seen:
                continue
            seen.add(child)
            queue.append(child)
            t = transformations[i]
            if child == int(edges[i][1]):  # the edge maps child (src) into parent (dst)
                out[child] = out[parent] @ t
            else:
                out[child] = out[parent] @ np.linalg.inv(t)
    return out


def chordal_rotation_averaging(n_nodes: int, edges: np.ndarray, rel_rots: np.ndarray,
                               weights: np.ndarray) -> np.ndarray:
    """Least-squares rotation averaging (chordal relaxation): R_a @ R_rel = R_b for each
    edge (dst a, src b), weighted by 1/uncertainty, node 0 fixed to the identity, each
    solved block projected to SO(3)."""
    rows, rhs = [], []
    dim = 9 * (n_nodes - 1)

    def block_index(i):
        return 9 * (i - 1)

    for e, (a, b) in enumerate(edges):
        a, b = int(a), int(b)
        w = 1.0 / max(float(weights[e]), 1e-6)
        Rr = rel_rots[e]
        for r in range(3):
            for c in range(3):
                row = np.zeros(dim)
                target = 0.0
                if a == 0:
                    target -= Rr[r, c]
                else:
                    for k in range(3):
                        row[block_index(a) + 3 * r + k] += Rr[k, c]
                if b == 0:
                    target += float(r == c)
                else:
                    row[block_index(b) + 3 * r + c] -= 1.0
                rows.append(w * row)
                rhs.append(w * target)
    if not rows:
        return np.repeat(np.eye(3)[None], n_nodes, axis=0)
    sol, *_ = np.linalg.lstsq(np.stack(rows), np.asarray(rhs), rcond=None)
    rots = [np.eye(3)]
    for i in range(1, n_nodes):
        u, _, vt = np.linalg.svd(sol[9 * (i - 1):9 * i].reshape(3, 3))
        rots.append(u @ np.diag([1.0, 1.0, np.linalg.det(u @ vt)]) @ vt)
    return np.stack(rots)


def global_alignment(n_nodes: int, edges: np.ndarray, transformations: np.ndarray,
                     uncertainty: np.ndarray, method: str = "mst") -> np.ndarray:
    """Global poses [n, 4, 4] from relative edge transforms: the spanning tree ("mst") or
    chordal rotation averaging plus a linear translation solve ("chordal")."""
    if len(edges) == 0:
        return np.repeat(np.eye(4)[None], n_nodes, axis=0)
    if method != "chordal":
        return spanning_tree_alignment(n_nodes, edges, transformations, uncertainty)
    rots = chordal_rotation_averaging(n_nodes, edges, transformations[:, :3, :3], uncertainty)
    # pose_b = pose_a @ T_ab => t_b = R_a @ t_ab + t_a, linear in the unknown t
    A = np.zeros((3 * len(edges), 3 * (n_nodes - 1)))
    rhs = np.zeros(3 * len(edges))
    for e, (a, b) in enumerate(edges):
        a, b = int(a), int(b)
        w = 1.0 / max(float(uncertainty[e]), 1e-6)
        contrib = rots[a] @ transformations[e, :3, 3]
        if b != 0:
            A[3 * e:3 * e + 3, 3 * (b - 1):3 * b] -= w * np.eye(3)
        if a != 0:
            A[3 * e:3 * e + 3, 3 * (a - 1):3 * a] += w * np.eye(3)
        rhs[3 * e:3 * e + 3] = -w * contrib
    sol, *_ = np.linalg.lstsq(A, rhs, rcond=None)
    out = np.repeat(np.eye(4)[None], n_nodes, axis=0)
    for i in range(n_nodes):
        out[i, :3, :3] = rots[i]
        if i > 0:
            out[i, :3, 3] = sol[3 * (i - 1):3 * i]
    return out
