"""The port's software z-buffer rasterizer (``renderer/rasterizer.py``): mirrors
``tests/test_rasterizer.py`` on the port's copy, and holds its frames equal to the JAX
package's on the same scene (both numpy).

Scene semantics mirror the reference Blender setup (renderer/myrenderer.py:30-64 camera +
sun, :173-176 keyframes, :264-284 video); here we verify the geometry of the rasterizer
itself (projection, occlusion, shadows, alpha) and the end-to-end artifact->frames path.
"""

import os

import numpy as np
import pytest

from puzzlefusion_plusplus_tpu_torch.renderer.rasterizer import (
    camera_rays,
    render_scene,
)

pytest.importorskip("matplotlib")


def _quad(center, half, axis="z"):
    """Axis-aligned square (two triangles) facing the camera direction-ish."""
    cx, cy, cz = center
    if axis == "z":
        v = np.array(
            [
                [cx - half, cy - half, cz],
                [cx + half, cy - half, cz],
                [cx + half, cy + half, cz],
                [cx - half, cy + half, cz],
            ]
        )
    else:  # vertical quad in the x=const plane
        v = np.array(
            [
                [cx, cy - half, cz - half],
                [cx, cy + half, cz - half],
                [cx, cy + half, cz + half],
                [cx, cy - half, cz + half],
            ]
        )
    f = np.array([[0, 1, 2], [0, 2, 3]])
    return v.astype(np.float64), f


def test_camera_rays_orthonormal_and_points_at_target():
    loc, R_wc, fx = camera_rays((2.0, -2.0, 1.5), (0.0, 0.0, 0.0), 45.0, (720, 720))
    np.testing.assert_allclose(R_wc @ R_wc.T, np.eye(3), atol=1e-12)
    # the look-at direction must be the camera's -Z axis
    fwd = -R_wc[2]
    expect = -loc / np.linalg.norm(loc)
    np.testing.assert_allclose(fwd, expect, atol=1e-12)
    assert fx == pytest.approx(720 * 45.0 / 36.0)


def test_render_scene_alpha_and_center_coverage():
    """A quad at the origin must cover the image center; background stays alpha 0."""
    v, f = _quad((0, 0, 0), 0.4, axis="x")
    img = render_scene([v], [f], resolution=(128, 128))
    assert img.shape == (128, 128, 4) and img.dtype == np.uint8
    assert img[64, 64, 3] == 255, "center pixel not covered"
    # corners: transparent background (film_transparent semantics)
    assert img[0, 0, 3] == 0 and img[-1, -1, 3] == 0
    # covered pixels are lit (ambient floor keeps them above pure black)
    assert img[64, 64, :3].max() > 20


def test_render_scene_occlusion_near_wins():
    """Two vertical quads along the camera ray: the nearer one must win the z-test."""
    # camera at (2,-2,1.5) looking at origin; nearer quad sits toward the camera
    near_v, near_f = _quad((0.6, -0.6, 0.45), 0.5, axis="x")
    far_v, far_f = _quad((-0.4, 0.4, -0.3), 0.9, axis="x")
    red = [(255, 0, 0), (0, 0, 255)]
    img = render_scene(
        [near_v, far_v], [near_f, far_f], resolution=(160, 160), colors=red
    )
    c = img[80, 80, :3].astype(int)
    # the near quad is red-based: red channel dominates at the center
    assert c[0] > c[2], f"far (blue) quad visible through near (red) quad: {c}"
    # draw order must not matter (true z-buffer, not painter)
    img2 = render_scene(
        [far_v, near_v], [far_f, near_f], resolution=(160, 160), colors=red[::-1]
    )
    c2 = img2[80, 80, :3].astype(int)
    assert c2[0] > c2[2]


def test_render_scene_shadow_on_ground():
    """An object above the ground must cast a sun-projected soft shadow (alpha ~0.45
    band on the z=-1 catcher plane, is_shadow_catcher semantics)."""
    v, f = _quad((0, 0, 0.2), 0.5, axis="z")
    img = render_scene([v], [f], resolution=(200, 200), ground_z=-1.0)
    a = img[..., 3]
    shadow = (a > 80) & (a < 180)  # the 0.45-alpha shadow band
    solid = a == 255
    assert shadow.sum() > 50, "no soft shadow rendered"
    assert solid.sum() > 50, "no solid geometry rendered"
    # shadow pixels are dark
    sh_rgb = img[..., :3][shadow]
    assert sh_rgb.max() < 60


def test_shadow_never_occludes_geometry():
    """Parts BELOW the ground plane (diffusion-noise early poses) must still render:
    a Blender shadow catcher is invisible to camera rays, so the shadow pass can never
    z-fight geometry out of the image (round-4 regression: shadow depths written into
    the shared z-buffer erased below-ground parts)."""
    above_v, above_f = _quad((0, 0, 0.2), 0.45, axis="z")
    # big quad well below the catcher plane, directly under the shadow footprint
    below_v, below_f = _quad((-0.4, 0.4, -2.0), 1.6, axis="z")
    img = render_scene(
        [above_v, below_v], [above_f, below_f], resolution=(200, 200),
        colors=[(255, 0, 0), (0, 0, 255)], ground_z=-1.0,
    )
    a = img[..., 3]
    blue = (img[..., 2].astype(int) > img[..., 0]) & (a == 255)
    assert blue.sum() > 500, "below-ground part erased by the shadow pass"
    # the shadow still exists on the transparent background
    soft = (a > 80) & (a < 180)
    assert soft.sum() > 20 or blue.sum() > 5000  # footprint may land fully on the part
    # a solo below-ground render (no occluder) covers the same pixels: geometry parity
    solo = render_scene([below_v], [below_f], resolution=(200, 200),
                        colors=[(0, 0, 255)], ground_z=-1.0)
    covered = solo[..., 3] == 255
    assert ((a == 255) | ~covered).all() or (covered & (a == 255)).sum() >= 0.99 * covered.sum()


def _write_mesh_tree(root, P=3):
    """Mesh dir with P tetrahedra as OBJ files (the fracture-part layout the reference
    renderer walks, myrenderer.py:100-120)."""
    d = os.path.join(root, "synthetic", "x")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    for p in range(P):
        v = rng.normal(size=(4, 3)) * 0.3
        lines = ["# tetra"]
        lines += [f"v {a} {b} {c}" for a, b, c in v]
        lines += ["f 1 2 3", "f 1 2 4", "f 1 3 4", "f 2 3 4"]
        with open(os.path.join(d, f"piece_{p}.obj"), "w") as fh:
            fh.write("\n".join(lines) + "\n")


def test_render_mesh_trajectory_end_to_end(tmp_path):
    """Artifacts + OBJ mesh tree -> PNG frames + video, fully headless (closes the
    bpy-gated half of component #27)."""
    from tests.test_torch_port_renderer import _write_artifacts

    from puzzlefusion_plusplus_tpu_torch.renderer import render_mesh_trajectory

    sample = tmp_path / "sample"
    sample.mkdir()
    _write_artifacts(str(sample), P=3, T=6)
    mesh_root = tmp_path / "meshes"
    _write_mesh_tree(str(mesh_root), P=3)

    out = tmp_path / "frames"
    written = render_mesh_trajectory(
        str(sample), str(mesh_root), str(out), resolution=(96, 96), every=3
    )
    pngs = [p for p in written if p.endswith(".png")]
    assert len(pngs) >= 2
    assert all(os.path.getsize(p) > 200 for p in pngs)
    # at least one frame has actual geometry (nonzero alpha)
    import matplotlib.image as mpimg

    frame = mpimg.imread(pngs[-1])
    assert frame.shape[2] == 4 and (frame[..., 3] > 0).sum() > 10
    videos = [p for p in written if p.endswith((".mp4", ".gif"))]
    assert videos and os.path.getsize(videos[0]) > 500


def test_render_mesh_trajectory_ignores_ply_duplicates(tmp_path):
    """A mesh dir holding BOTH .obj and converted .ply duplicates must enumerate only the
    .obj files (matching preprocessing / reference myrenderer.py:133-136) — doubling the
    part list would misalign mesh<->pose ordering against the artifact part indices
    (r4 advisor finding)."""
    from tests.test_torch_port_renderer import _write_artifacts

    from puzzlefusion_plusplus_tpu_torch.data import meshio
    from puzzlefusion_plusplus_tpu_torch.renderer import render_mesh_trajectory

    sample = tmp_path / "sample"
    sample.mkdir()
    _write_artifacts(str(sample), P=3, T=6)
    mesh_root = tmp_path / "meshes"
    _write_mesh_tree(str(mesh_root), P=3)
    d = os.path.join(str(mesh_root), "synthetic", "x")
    for f in sorted(os.listdir(d)):  # plant converted duplicates
        m = meshio.load(os.path.join(d, f))
        with open(os.path.join(d, f.replace(".obj", ".ply")), "w") as fh:
            fh.write("ply\nformat ascii 1.0\n")
            fh.write(f"element vertex {len(m.vertices)}\n")
            fh.write("property float x\nproperty float y\nproperty float z\n")
            fh.write(f"element face {len(m.faces)}\n")
            fh.write("property list uchar int vertex_indices\nend_header\n")
            for v in m.vertices:
                fh.write(f"{v[0]} {v[1]} {v[2]}\n")
            for fc in m.faces:
                fh.write(f"3 {fc[0]} {fc[1]} {fc[2]}\n")

    out = tmp_path / "frames"
    written = render_mesh_trajectory(
        str(sample), str(mesh_root), str(out), resolution=(64, 64), every=3,
        make_video=False,
    )
    assert [p for p in written if p.endswith(".png")]  # would IndexError/misalign if doubled


def test_meshio_ply_missing_xyz_raises_with_path(tmp_path):
    """A vertex element without x/y/z scalars must raise a ValueError naming the file, not
    a bare KeyError or silent all-zero vertices (r4 advisor finding)."""
    import pytest

    from puzzlefusion_plusplus_tpu_torch.data import meshio

    p = tmp_path / "weird.ply"
    p.write_text(
        "ply\nformat ascii 1.0\n"
        "element vertex 1\nproperty float px\nproperty float py\nproperty float pz\n"
        "element face 1\nproperty list uchar int vertex_indices\nend_header\n"
        "0 0 0\n3 0 0 0\n"
    )
    with pytest.raises(ValueError, match="lacks x/y/z"):
        meshio.load_ply(str(p))


def test_render_scene_equals_jax():
    from puzzlefusion_plusplus_tpu.renderer.rasterizer import render_scene as jrender

    near_v, near_f = _quad((0.6, -0.6, 0.45), 0.5, axis="x")
    far_v, far_f = _quad((-0.4, 0.4, -0.3), 0.9, axis="z")
    args = ([near_v, far_v], [near_f, far_f])
    kw = dict(resolution=(96, 96), colors=[(255, 0, 0), (0, 0, 255)], ground_z=-1.0)
    np.testing.assert_array_equal(render_scene(*args, **kw), jrender(*args, **kw))
