"""The port's renderer (``renderer/``) and its ``renderer.render_results`` entry, on the CPU.

Mirrors ``tests/test_renderer.py`` on the port's copies, on artifacts that the tests write
themselves (a test is skipped only where an optional package, matplotlib or cv2, is
absent), and holds the port's pose composition equal to the JAX package's (both numpy).
``tests/test_torch_port_rasterizer.py`` mirrors the rasterizer's tests."""

import os

import numpy as np
import pytest

from puzzlefusion_plusplus_tpu_torch.renderer import (
    compose_render_transform,
    load_inference_dir,
    trajectory_world_points,
)


def _write_artifacts(d, P=3, T=6, seed=0):
    rng = np.random.default_rng(seed)
    from scipy.spatial.transform import Rotation as R

    gt = np.zeros((P, 7), np.float32)
    for p in range(P):
        gt[p, :3] = rng.normal(size=3) * 0.3
        gt[p, 3:] = R.random(random_state=rng).as_quat()[[3, 0, 1, 2]]
    traj = np.zeros((T, P, 7), np.float32)
    for t in range(T):
        for p in range(P):
            traj[t, p, :3] = rng.normal(size=3) * (1 - t / (T - 1))
            traj[t, p, 3:] = R.random(random_state=rng).as_quat()[[3, 0, 1, 2]]
    traj[-1] = gt  # final step = GT poses
    init = np.zeros(7, np.float32)
    init[:3] = rng.normal(size=3) * 0.2
    init[3:] = R.random(random_state=rng).as_quat()[[3, 0, 1, 2]]
    np.save(os.path.join(d, "predict_0.5.npy"), traj)
    np.save(os.path.join(d, "gt.npy"), gt)
    np.save(os.path.join(d, "init_pose.npy"), init)
    open(os.path.join(d, "mesh_file_path.txt"), "w").write("synthetic/x")
    return gt, traj, init


def test_pose_composition_identity_when_pred_equals_gt(tmp_path):
    """When the predicted pose equals the GT pose, a GT-frame point must map to itself —
    the defining invariant of myrenderer.compute_final_transformation."""
    d = str(tmp_path)
    gt, traj, init = _write_artifacts(d)
    art = load_inference_dir(d)
    assert art["acc"] == 0.5
    P = gt.shape[0]
    pts = np.random.default_rng(1).normal(size=(P, 50, 3)).astype(np.float32)
    world = trajectory_world_points(pts, art, art["trajectory"].shape[0] - 1)
    np.testing.assert_allclose(world, pts, atol=1e-4)


def test_compose_transform_is_rigid(tmp_path):
    d = str(tmp_path)
    gt, traj, init = _write_artifacts(d, seed=2)
    m = compose_render_transform(init, gt[0], traj[0, 0])
    r = m[:3, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    assert np.allclose(m[3], [0, 0, 0, 1])


def test_render_frames_and_video(tmp_path):
    """Headless render must produce frames AND an assembled video (reference save_video,
    myrenderer.py:264-284 — here via the ffmpeg/OpenCV/GIF encoder chain)."""
    pytest.importorskip("matplotlib")
    from puzzlefusion_plusplus_tpu_torch.renderer import render_trajectory

    d = str(tmp_path)
    gt, traj, init = _write_artifacts(d)
    pts = np.random.default_rng(1).normal(size=(3, 40, 3)).astype(np.float32)
    paths = render_trajectory(d, pts, every=3)
    pngs = [p for p in paths if p.endswith(".png")]
    assert len(pngs) >= 2
    assert all(os.path.getsize(p) > 1000 for p in pngs)
    videos = [p for p in paths if p.endswith((".mp4", ".gif"))]
    assert videos, "no video assembled despite cv2/PIL being available"
    assert os.path.getsize(videos[0]) > 1000

    # make_gif=False keeps the frames-only contract: no mp4/GIF written
    d2 = str(tmp_path / "frames_only")
    paths2 = render_trajectory(d, pts, out_dir=d2, every=3, make_gif=False)
    assert paths2 and all(p.endswith(".png") for p in paths2)
    assert not [f for f in os.listdir(d2) if f.endswith((".mp4", ".gif"))]


def test_assemble_video_cv2_fallback(tmp_path):
    """assemble_video must write a real .mp4 via OpenCV when ffmpeg is absent."""
    cv2 = pytest.importorskip("cv2")
    frames = []
    for i in range(4):
        img = np.full((64, 64, 3), i * 60, np.uint8)
        p = str(tmp_path / f"{i:04d}.png")
        cv2.imwrite(p, img)
        frames.append(p)
    from puzzlefusion_plusplus_tpu_torch.renderer.artifacts import assemble_video

    out = assemble_video(frames, str(tmp_path / "v.mp4"), fps=4, hold_last_s=0.5)
    assert out is not None and out.endswith((".mp4", ".gif"))
    assert os.path.getsize(out) > 500
    if out.endswith(".mp4"):
        cap = cv2.VideoCapture(out)
        assert cap.isOpened()
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        assert n >= 4
        cap.release()


def test_render_results_end_to_end(tmp_path):
    """render_results.py path: synthetic inference dir + pc_data -> frames + video."""
    pytest.importorskip("matplotlib")
    from puzzlefusion_plusplus_tpu_torch.renderer import render_results

    inf_dir = tmp_path / "inference"
    sample = inf_dir / "10000"
    sample.mkdir(parents=True)
    _write_artifacts(str(sample), P=3, T=6)
    pc_dir = tmp_path / "pc_data"
    pc_dir.mkdir()
    np.savez(
        pc_dir / "10000.npz",
        part_valids=np.array([1, 1, 1, 0], np.float32),
        part_pcs_gt=np.random.default_rng(0).normal(size=(4, 30, 3)).astype(np.float32),
    )
    written = render_results(str(inf_dir), str(pc_dir), every=3)
    assert any(w.endswith(".png") for w in written)
    assert any(w.endswith((".mp4", ".gif")) for w in written)


def test_pose_composition_equals_jax(tmp_path):
    from puzzlefusion_plusplus_tpu import renderer as jrenderer

    d = str(tmp_path)
    gt, traj, init = _write_artifacts(d, P=4, T=5, seed=3)
    art, jart = load_inference_dir(d), jrenderer.load_inference_dir(d)
    pts = np.random.default_rng(2).normal(size=(4, 30, 3)).astype(np.float32)
    for t in range(traj.shape[0]):
        np.testing.assert_array_equal(trajectory_world_points(pts, art, t),
                                      jrenderer.trajectory_world_points(pts, jart, t))
    np.testing.assert_array_equal(compose_render_transform(init, gt[1], traj[2, 1]),
                                  jrenderer.compose_render_transform(init, gt[1], traj[2, 1]))


@pytest.mark.parametrize("mode", ["pc_data", "mesh_root"])
def test_render_results_entry(tmp_path, mode):
    """``python -m puzzlefusion_plusplus_tpu_torch.render_results`` in both modes,
    on an inference directory in the format ``inference/run.py`` writes."""
    pytest.importorskip("matplotlib")
    from puzzlefusion_plusplus_tpu_torch.render_results import main

    inf_dir = tmp_path / "inference"
    for sid in ("10000", "10001"):
        (inf_dir / sid).mkdir(parents=True)
        _write_artifacts(str(inf_dir / sid), P=3, T=6)
    out = tmp_path / "render_out"
    if mode == "pc_data":
        pc_dir = tmp_path / "pc_data"
        pc_dir.mkdir()
        for sid in ("10000", "10001"):
            np.savez(pc_dir / f"{sid}.npz", part_valids=np.array([1, 1, 1, 0], np.float32),
                     part_pcs_gt=np.random.default_rng(0).normal(size=(4, 30, 3))
                     .astype(np.float32))
        written = main([f"inference_dir={inf_dir}", f"pc_data_dir={pc_dir}", "num_samples=1",
                        "every=3"])
    else:
        from tests.test_rasterizer import _write_mesh_tree

        _write_mesh_tree(str(tmp_path / "meshes"), P=3)
        written = main([f"inference_dir={inf_dir}", f"mesh_root={tmp_path / 'meshes'}",
                        f"out_dir={out}", "every=3"])
        assert {os.path.basename(os.path.dirname(w)) for w in written} == {"10000", "10001"}
    assert any(w.endswith(".png") for w in written)
    assert any(w.endswith((".mp4", ".gif")) for w in written)
