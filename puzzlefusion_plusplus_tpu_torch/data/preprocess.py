"""A copy of ``puzzlefusion_plusplus_tpu/data/preprocess.py`` (numpy only), kept in the
port so that it imports nothing of the JAX package.

Mesh -> pc_data preprocessing (the reference's generate_pc_data.py + mesh dataset).

Port of the Breaking Bad mesh pipeline (vqvae/dataset/dataset.py): load each fracture's part
.obj meshes, sample ``num_points`` surface points per part (area-weighted), build the
part-adjacency graph by the shared-vertex test at 1e-5 precision (:85-126), pick the
largest-extent part as the reference part (:200-204), and write one .npz per shape with the
pc_data schema (generate_pc_data.py:31-41).

Mesh loading prefers ``trimesh`` when installed (exotic encodings) and otherwise uses the
dependency-free internal loader (data/meshio.py, OBJ + PLY) — the pipeline runs on real
mesh files either way. Without meshes, use data/synthetic.py to generate fixtures.
"""

from __future__ import annotations

import os

import numpy as np


def _require_trimesh():
    """Resolve the mesh-loading module: trimesh if installed, else the internal
    numpy loader (duck-compatible: .load(path, force='mesh') -> mesh with
    vertices/triangles/area_faces/extents). Name kept for test monkeypatching."""
    try:
        import trimesh  # noqa: F401

        return trimesh
    except ImportError:
        from puzzlefusion_plusplus_tpu_torch.data import meshio

        return meshio


def sample_mesh_surface(mesh, n: int, rng: np.random.Generator) -> np.ndarray:
    """Area-weighted surface sampling (trimesh.sample.sample_surface semantics)."""
    areas = mesh.area_faces
    probs = areas / areas.sum()
    face_idx = rng.choice(len(areas), n, p=probs)
    tri = mesh.triangles[face_idx]  # [n, 3, 3]
    u, v = rng.random((2, n))
    flip = u + v > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    return (
        tri[:, 0] + u[:, None] * (tri[:, 1] - tri[:, 0]) + v[:, None] * (tri[:, 2] - tri[:, 0])
    ).astype(np.float32)


def shared_vertex_graph(meshes, precision: float = 1e-5) -> np.ndarray:
    """Adjacency by rounded-vertex intersection (reference :85-126)."""
    P = len(meshes)
    vertex_sets = []
    for m in meshes:
        v = np.round(np.asarray(m.vertices) / precision).astype(np.int64)
        vertex_sets.append({tuple(row) for row in v})
    graph = np.zeros((P, P), bool)
    for i in range(P):
        for j in range(i + 1, P):
            if vertex_sets[i] & vertex_sets[j]:
                graph[i, j] = graph[j, i] = True
    return graph


def process_fracture_dir(
    fracture_dir: str, num_points: int, rng: np.random.Generator
) -> dict | None:
    """One fracture directory of part .obj files -> unpadded shape dict."""
    trimesh = _require_trimesh()
    objs = sorted(f for f in os.listdir(fracture_dir) if f.endswith(".obj"))
    if len(objs) < 2:
        return None
    meshes = [trimesh.load(os.path.join(fracture_dir, f), force="mesh") for f in objs]
    part_pcs = np.stack([sample_mesh_surface(m, num_points, rng) for m in meshes])
    graph = shared_vertex_graph(meshes)
    extents = np.array([m.extents.max() for m in meshes])
    ref_part = np.zeros(len(meshes), bool)
    ref_part[np.argmax(extents)] = True
    return {
        "part_pcs_gt": part_pcs,
        "graph": graph,
        "ref_part": ref_part,
        "num_parts": len(meshes),
        "mesh_file_path": fracture_dir,
    }


def generate_pc_data(
    mesh_root: str,
    out_dir: str,
    split: str = "train",
    num_points: int = 1000,
    max_num_part: int = 20,
    min_num_part: int = 2,
    seed: int = 0,
) -> int:
    """Walk a Breaking-Bad-style mesh tree and dump pc_data .npz files. Returns count."""
    from puzzlefusion_plusplus_tpu_torch.data.synthetic import _pad, _pad_square

    rng = np.random.default_rng(seed)
    save_dir = os.path.join(out_dir, split)
    os.makedirs(save_dir, exist_ok=True)
    count = 0
    for root, dirs, files in sorted(os.walk(mesh_root)):
        if not any(f.endswith(".obj") for f in files):
            continue
        shape = process_fracture_dir(root, num_points, rng)
        if shape is None or not (min_num_part <= shape["num_parts"] <= max_num_part):
            continue
        part_valids = np.zeros(max_num_part, np.float32)
        part_valids[: shape["num_parts"]] = 1
        np.savez(
            os.path.join(save_dir, f"{count:05d}.npz"),
            data_id=count,
            part_valids=part_valids,
            num_parts=shape["num_parts"],
            mesh_file_path=shape["mesh_file_path"],
            graph=_pad_square(shape["graph"], max_num_part),
            category=os.path.basename(os.path.dirname(root)),
            part_pcs_gt=_pad(shape["part_pcs_gt"], max_num_part),
            ref_part=_pad(shape["ref_part"].astype(np.float32)[:, None], max_num_part)[:, 0]
            .astype(bool),
        )
        count += 1
    return count
