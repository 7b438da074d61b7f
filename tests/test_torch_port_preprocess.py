"""The port's mesh preprocessing (``data/meshio.py``, ``data/preprocess.py``, the
``data.generate_pc_data`` entry) and verifier-data generation, on the CPU.

Mirrors ``tests/test_preprocess.py`` on the port's modules, with its OBJ and PLY fixtures
written by the tests themselves (its duck-typed ``StubMesh`` stands in for ``trimesh``,
which is optional and absent here), and holds the port against the JAX package: the meshes
each loader reads and the ``.npz`` trees each preprocessor writes are equal, exactly (both
are numpy on the same inputs and the same seeded rng)."""

import os

import numpy as np
import pytest
import torch

from tests.test_preprocess import BOX_FACES, StubMesh, _box_obj, _StubTrimeshModule  # noqa: F401

from puzzlefusion_plusplus_tpu.data import meshio as jmeshio
from puzzlefusion_plusplus_tpu.data import preprocess as jpre
from puzzlefusion_plusplus_tpu_torch.data import meshio, preprocess
from puzzlefusion_plusplus_tpu_torch.data.generate_pc_data import main as gen_main
from puzzlefusion_plusplus_tpu_torch.data.preprocess import (
    generate_pc_data,
    sample_mesh_surface,
    shared_vertex_graph,
)

torch.set_num_threads(2)


def _assert_trees_equal(a_dir, b_dir):
    names = sorted(os.listdir(a_dir))
    assert names and names == sorted(os.listdir(b_dir))
    for name in names:
        a = np.load(os.path.join(a_dir, name), allow_pickle=True)
        b = np.load(os.path.join(b_dir, name), allow_pickle=True)
        assert a.files == b.files
        for k in a.files:
            if a[k].dtype == object:
                assert str(a[k]) == str(b[k]), k
            else:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sample_mesh_surface_area_weighted_on_surface():
    mesh = StubMesh(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [10, 0, 0], [12, 0, 0], [10, 2, 0]],
        [[0, 1, 2], [3, 4, 5]],
    )
    pts = sample_mesh_surface(mesh, 4000, np.random.default_rng(0))
    assert pts.shape == (4000, 3) and pts.dtype == np.float32
    np.testing.assert_allclose(pts[:, 2], 0.0, atol=1e-7)
    assert abs(np.mean(pts[:, 0] >= 9.0) - 0.8) < 0.03  # area weighting (0.5 vs 2.0)
    small = pts[pts[:, 0] < 9.0]
    assert (small[:, 0] >= -1e-6).all() and (small[:, 1] >= -1e-6).all()
    assert (small[:, 0] + small[:, 1] <= 1 + 1e-5).all()
    np.testing.assert_array_equal(
        pts, jpre.sample_mesh_surface(mesh, 4000, np.random.default_rng(0)))


def test_shared_vertex_graph_adjacency():
    a = StubMesh([[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[0, 1, 2]])
    b = StubMesh([[1, 0, 0], [0, 1, 0], [1, 1, 0]], [[0, 1, 2]])
    c = StubMesh([[5, 5, 5], [6, 5, 5], [5, 6, 5]], [[0, 1, 2]])
    g = shared_vertex_graph([a, b, c])
    assert g[0, 1] and g[1, 0] and not g[0, 2] and not g[1, 2]
    assert not g.diagonal().any()
    b2 = StubMesh(np.asarray(b.vertices) + 1e-7, [[0, 1, 2]])
    assert shared_vertex_graph([a, b2])[0, 1]
    np.testing.assert_array_equal(g, jpre.shared_vertex_graph([a, b, c]))


def test_generate_pc_data_end_to_end(tmp_path, monkeypatch):
    """2-box fracture on disk -> pc_data tree (the stub trimesh), equal to the JAX
    package's, which the port's dataset readers consume."""
    mesh_root = tmp_path / "meshes" / "everyday" / "box" / "fractured_0"
    os.makedirs(mesh_root)
    _box_obj(mesh_root / "piece_0.obj", [-1, 0, 0], [0, 1, 1])
    _box_obj(mesh_root / "piece_1.obj", [0, 0, 0], [1.5, 1, 1])
    monkeypatch.setattr(preprocess, "_require_trimesh", lambda: _StubTrimeshModule)
    monkeypatch.setattr(jpre, "_require_trimesh", lambda: _StubTrimeshModule)
    out = str(tmp_path / "pc_data")
    kw = dict(split="train", num_points=256, max_num_part=5)
    assert generate_pc_data(str(tmp_path / "meshes"), out, **kw) == 1
    assert jpre.generate_pc_data(str(tmp_path / "meshes"), str(tmp_path / "jax"), **kw) == 1
    _assert_trees_equal(os.path.join(out, "train"), str(tmp_path / "jax" / "train"))
    d = np.load(os.path.join(out, "train", "00000.npz"), allow_pickle=True)
    assert d["num_parts"] == 2 and d["part_valids"].tolist() == [1, 1, 0, 0, 0]
    assert d["graph"][0, 1] and d["graph"][1, 0] and not d["graph"][2:].any()
    assert d["ref_part"].tolist() == [False, True, False, False, False]
    assert str(d["category"]) == "box"
    from puzzlefusion_plusplus_tpu_torch.data import DenoiserDataset, VQVAEDataset

    rng = np.random.default_rng(0)
    s = VQVAEDataset(os.path.join(out, "train"), max_num_part=5).get(0, rng)
    assert s["part_pcs"].shape == (5, 256, 3) and np.abs(s["part_pcs"]).max() <= 1.0 + 1e-6
    s = DenoiserDataset(os.path.join(out, "train"), mode="train", max_num_part=5).get(0, rng)
    for k in ("part_pcs", "part_trans", "part_rots", "part_scale", "ref_part"):
        assert np.isfinite(np.asarray(s[k], np.float32)).all(), k


def test_generate_verifier_data_cpu(tmp_path):
    """data/verifier_gen.py end to end on the CPU: a small denoiser's sampler -> verifier
    files that the port's VerifierDataset serves."""
    from puzzlefusion_plusplus_tpu_torch.data import VerifierDataset, generate_dataset
    from puzzlefusion_plusplus_tpu_torch.data.verifier_gen import generate_verifier_data
    from puzzlefusion_plusplus_tpu_torch.inference.sampler import make_frozen_encoder
    from puzzlefusion_plusplus_tpu_torch.models.denoiser import make_denoiser
    from puzzlefusion_plusplus_tpu_torch.models.scheduler import DDPMParams
    from puzzlefusion_plusplus_tpu_torch.models.vqvae import VQVAE
    from puzzlefusion_plusplus_tpu_torch.training.denoiser import make_sample_fn
    from puzzlefusion_plusplus_tpu_torch.utils.config import Config

    root = str(tmp_path)
    generate_dataset(root, num_shapes=2, seed=6, split="train", min_parts=3, max_parts=4,
                     n_points=96, with_verifier=False)
    cfg = Config()
    cfg.data.max_num_part = 5
    cfg.denoiser.embed_dim, cfg.denoiser.num_layers, cfg.denoiser.num_heads = 32, 1, 2
    torch.manual_seed(0)
    encoder = make_frozen_encoder(VQVAE(32, 16, 25, 64, sa_npoints=(24, 12),
                                        sa_nsamples=(8, 8, 8)))
    sample_fn = make_sample_fn(make_denoiser(cfg).eval(), encoder, DDPMParams.piecewise(),
                               cfg.denoiser.num_inference_steps)
    out_dir = root + "/verifier_data"
    written = generate_verifier_data(sample_fn, root + "/pc_data/train",
                                     root + "/matching_data", out_dir, max_num_part=5,
                                     rounds=2, device="cpu")
    assert written == 4 and len(os.listdir(out_dir)) == 4
    for f in sorted(os.listdir(out_dir)):
        d = np.load(os.path.join(out_dir, f))
        E = len(d["cls_gt"])
        assert E >= 3 and d["edge_features"].shape == (E, 6) and d["edge_indices"].shape == (E, 2)
        assert set(np.unique(d["cls_gt"])) <= {0, 1}
        assert (d["edge_features"] >= 0).all() and np.isfinite(d["edge_features"]).all()
    s = VerifierDataset(out_dir, mode="train").get(0, np.random.default_rng(0))
    assert s["edge_features"].shape[1] == 7 and np.isfinite(s["edge_features"]).all()


def test_meshio_obj_quirks(tmp_path):
    p = tmp_path / "quirks.obj"
    p.write_text(
        "# unit square in z=0, one quad, then a tri via negative relative indices\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vt 0 0\nvn 0 0 1\n"
        "f 1/1/1 2/1/1 3/1/1 4/1/1\n"
        "v 0 0 1\nv 1 0 1\nv 1 1 1\n"
        "f -3//1 -2// -1\n"
    )
    m = meshio.load_obj(str(p))
    assert m.vertices.shape == (7, 3) and m.faces.shape == (3, 3)
    np.testing.assert_array_equal(m.faces[:2], [[0, 1, 2], [0, 2, 3]])
    np.testing.assert_array_equal(m.faces[2], [4, 5, 6])
    np.testing.assert_allclose(m.area_faces, [0.5, 0.5, 0.5])
    np.testing.assert_allclose(m.extents, [1, 1, 1])
    j = jmeshio.load_obj(str(p))
    np.testing.assert_array_equal(m.vertices, j.vertices)
    np.testing.assert_array_equal(m.faces, j.faces)


def _ply_fixtures(tmp_path):
    import struct

    verts = np.array([[0, 0, 0], [2, 0, 0], [0, 3, 0], [0, 0, 4]], np.float64)
    faces = [[0, 1, 2], [0, 1, 3]]
    pa = tmp_path / "m.ply"
    pa.write_text(
        "ply\nformat ascii 1.0\ncomment test\n"
        "element vertex 4\nproperty float x\nproperty float y\nproperty float z\n"
        "element face 2\nproperty list uchar int vertex_indices\nend_header\n"
        + "".join(f"{v[0]} {v[1]} {v[2]}\n" for v in verts)
        + "".join(f"3 {f[0]} {f[1]} {f[2]}\n" for f in faces)
    )
    pb = tmp_path / "mb.ply"
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        "element vertex 4\nproperty float x\nproperty float y\nproperty float z\n"
        "element face 2\nproperty list uchar int vertex_indices\nend_header\n"
    )
    with open(pb, "wb") as fh:
        fh.write(header.encode())
        fh.write(verts.astype("<f4").tobytes())
        for f in faces:
            fh.write(struct.pack("<B3i", 3, *f))
    return verts, faces, pa, pb


def test_meshio_ply_ascii_and_binary(tmp_path):
    verts, faces, pa, pb = _ply_fixtures(tmp_path)
    ma, mb = meshio.load_ply(str(pa)), meshio.load_ply(str(pb))
    for m in (ma, mb):
        np.testing.assert_allclose(m.vertices, verts)
        np.testing.assert_array_equal(m.faces, faces)
    np.testing.assert_allclose(mb.area_faces, ma.area_faces)
    np.testing.assert_array_equal(mb.vertices, jmeshio.load_ply(str(pb)).vertices)


def test_generate_pc_data_real_loader_no_trimesh(tmp_path):
    """The real mesh-file path with no stub and no trimesh: OBJ files through the port's
    meshio, the tree equal to the JAX package's."""
    mesh_root = tmp_path / "meshes" / "everyday" / "mug" / "fractured_3"
    os.makedirs(mesh_root)
    _box_obj(mesh_root / "piece_0.obj", [-1, 0, 0], [0, 1, 1])
    _box_obj(mesh_root / "piece_1.obj", [0, 0, 0], [2, 1, 1])
    _box_obj(mesh_root / "piece_2.obj", [5, 5, 5], [5.5, 5.5, 5.5])
    out = str(tmp_path / "pc_data")
    kw = dict(split="val", num_points=128, max_num_part=4)
    assert generate_pc_data(str(tmp_path / "meshes"), out, **kw) == 1
    jpre.generate_pc_data(str(tmp_path / "meshes"), str(tmp_path / "jax"), **kw)
    _assert_trees_equal(os.path.join(out, "val"), str(tmp_path / "jax" / "val"))
    d = np.load(os.path.join(out, "val", "00000.npz"), allow_pickle=True)
    assert d["num_parts"] == 3
    g = d["graph"]
    assert g[0, 1] and g[1, 0] and not g[0, 2] and not g[1, 2]
    assert d["ref_part"].tolist() == [False, True, False, False]
    pts = d["part_pcs_gt"][2]
    assert (pts >= 5 - 1e-5).all() and (pts <= 5.5 + 1e-5).all()


def test_meshio_ply_property_order_respected(tmp_path):
    import struct

    verts = np.array([[0, 0, 0], [2, 0, 0], [0, 3, 0], [0, 0, 4]], np.float64)
    faces = [[0, 1, 2], [0, 1, 3]]
    pa = tmp_path / "weird.ply"
    pa.write_text(
        "ply\nformat ascii 1.0\n"
        "element vertex 4\nproperty float x\nproperty float y\nproperty float z\n"
        "property float confidence\nproperty list uchar float moments\n"
        "element face 2\nproperty uchar flags\n"
        "property list uchar int vertex_indices\nend_header\n"
        + "".join(f"{v[0]} {v[1]} {v[2]} 0.9 2 1.0 2.0\n" for v in verts)
        + "".join(f"7 3 {f[0]} {f[1]} {f[2]}\n" for f in faces)
    )
    pb = tmp_path / "weird_bin.ply"
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        "element vertex 4\nproperty float x\nproperty float y\nproperty float z\n"
        "property list uchar float moments\n"
        "element face 2\nproperty uchar flags\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    with open(pb, "wb") as fh:
        fh.write(header.encode())
        for v in verts:
            fh.write(struct.pack("<3f", *v))
            fh.write(struct.pack("<B2f", 2, 1.0, 2.0))
        for f in faces:
            fh.write(struct.pack("<BB3i", 7, 3, *f))
    for p in (pa, pb):
        m = meshio.load_ply(str(p))
        np.testing.assert_allclose(m.vertices, verts)
        np.testing.assert_array_equal(m.faces, faces)


@pytest.mark.parametrize("mode", ["mesh_root", "synthetic"])
def test_generate_pc_data_entry(tmp_path, mode, capsys):
    """``python -m puzzlefusion_plusplus_tpu_torch.data.generate_pc_data`` in both modes."""
    out = str(tmp_path / "out")
    if mode == "synthetic":
        lines = gen_main(["synthetic=1", f"out={out}", "num_shapes=4", "seed=3"])
        assert lines == [f"wrote synthetic dataset to {out}"]
        assert len(os.listdir(os.path.join(out, "pc_data", "train"))) == 4
        assert len(os.listdir(os.path.join(out, "pc_data", "val"))) == 1
        return
    for split, lo in (("train", 0), ("val", 3)):
        d = tmp_path / "meshes" / split / "everyday" / "box" / "fractured_0"
        os.makedirs(d)
        _box_obj(d / "piece_0.obj", [lo - 1, 0, 0], [lo, 1, 1])
        _box_obj(d / "piece_1.obj", [lo, 0, 0], [lo + 1, 1, 1])
    lines = gen_main([f"mesh_root={tmp_path / 'meshes'}", f"out={out}", "num_points=64"])
    assert lines == ["train: 1 shapes", "val: 1 shapes"]
    assert capsys.readouterr().out.splitlines()[-2:] == lines
    d = np.load(os.path.join(out, "train", "00000.npz"), allow_pickle=True)
    assert d["part_pcs_gt"].shape[1:] == (64, 3)
