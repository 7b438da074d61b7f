"""A copy of ``puzzlefusion_plusplus_tpu/renderer/artifacts.py`` (numpy only), kept in the
port so that it imports nothing of the JAX package.

Inference-artifact loading + pose composition for rendering (reference renderer/).

The artifact contract is byte-compatible with the reference (auto_aggl.py:322-357 writer,
myrenderer.py:101-113 reader): per-sample directory with ``predict_{acc}.npy``
[T, P_valid, 7] pose trajectory, ``gt.npy`` [P_valid, 7], ``init_pose.npy`` [7]
(whole-shape augmentation pose), ``mesh_file_path.txt``.

``compose_render_transform`` reproduces the Blender-math chain of
myrenderer.compute_final_transformation (:240-260): map a GT-frame mesh part through the
inverse init pose, the inverse GT part pose (into the part's local frame), the predicted
part pose, and the init pose back to world.
"""

from __future__ import annotations

import glob
import os

import numpy as np

def _quat_to_matrix_np(q: np.ndarray) -> np.ndarray:
    """Scalar-first quaternion -> rotation matrix (pure numpy; the renderer is a host tool
    and must not touch the accelerator)."""
    w, x, y, z = q
    s = 2.0 / np.dot(q, q)
    return np.array([
        [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
        [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
        [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
    ])


def load_inference_dir(sample_dir: str) -> dict:
    predict_files = glob.glob(os.path.join(sample_dir, "predict_*.npy"))
    if not predict_files:
        raise FileNotFoundError(f"no predict_*.npy in {sample_dir}")
    predict_file = predict_files[0]
    acc = os.path.basename(predict_file)[len("predict_"):-len(".npy")]
    out = {
        "trajectory": np.load(predict_file),  # [T, P, 7]
        "gt": np.load(os.path.join(sample_dir, "gt.npy")),  # [P, 7]
        "init_pose": np.load(os.path.join(sample_dir, "init_pose.npy")),  # [7]
        "acc": float(acc),
    }
    mesh_txt = os.path.join(sample_dir, "mesh_file_path.txt")
    if os.path.exists(mesh_txt):
        out["mesh_file_path"] = open(mesh_txt).read()
    return out


def _affine(trans, quat):
    m = np.eye(4)
    m[:3, :3] = _quat_to_matrix_np(np.asarray(quat, np.float64))
    m[:3, 3] = trans
    return m


def _inv_rigid(m: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = m[:3, :3].T
    out[:3, 3] = -m[:3, :3].T @ m[:3, 3]
    return out


def compose_render_transform(
    init_pose: np.ndarray,  # [7] whole-shape (t, q)
    gt_pose: np.ndarray,  # [7] part GT pose
    pred_pose: np.ndarray,  # [7] part predicted pose (possibly unnormalized quat)
) -> np.ndarray:
    """4x4 world transform for a mesh part stored in its GT assembled frame
    (myrenderer.py:240-260: R4 T4 T3 R3 R2 T2 T1 R1)."""
    t_i, q_i = init_pose[:3], init_pose[3:]
    t_g, q_g = gt_pose[:3], gt_pose[3:]
    t_p = pred_pose[:3]
    q_p = pred_pose[3:] / max(np.linalg.norm(pred_pose[3:]), 1e-12)

    rot1 = _inv_rigid(_affine(np.zeros(3), q_i))  # inverse init rotation
    trans1 = np.eye(4); trans1[:3, 3] = -t_i
    rot2 = _inv_rigid(_affine(np.zeros(3), q_g))
    trans2 = np.eye(4); trans2[:3, 3] = -t_g
    rot3 = _affine(np.zeros(3), q_p)
    trans3 = np.eye(4); trans3[:3, 3] = t_p
    rot4 = _affine(np.zeros(3), q_i)
    trans4 = np.eye(4); trans4[:3, 3] = t_i
    return rot4 @ trans4 @ trans3 @ rot3 @ rot2 @ trans2 @ trans1 @ rot1


def assemble_video(frame_paths: list[str], video_path: str, fps: int = 8,
                   hold_last_s: float = 2.0) -> str | None:
    """Compile PNG frames into a video (reference save_video, myrenderer.py:264-284:
    ffmpeg libx264 with the last frame held ~2 s). Encoder chain: ffmpeg when installed ->
    OpenCV mp4v (no external binary) -> animated GIF (Pillow). Returns the written path,
    or None when no encoder is available."""
    import subprocess

    frame_paths = [p for p in frame_paths if p.endswith(".png")]
    if not frame_paths:
        return None
    frames_dir = os.path.dirname(frame_paths[0])
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps), "-i", f"{frames_dir}/%04d.png",
             "-vf", f"tpad=stop_mode=clone:stop_duration={hold_last_s}",
             "-c:v", "libx264", "-pix_fmt", "yuv420p", "-crf", "17", video_path],
            check=True, capture_output=True,
        )
        return video_path
    except (FileNotFoundError, subprocess.CalledProcessError):
        if os.path.exists(video_path):  # ffmpeg -y can leave a partial file on failure
            os.remove(video_path)
    try:
        import cv2

        first = cv2.imread(frame_paths[0])
        if first is None:
            raise ValueError(f"unreadable frame: {frame_paths[0]}")
        h, w = first.shape[:2]
        writer = cv2.VideoWriter(
            video_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
        )
        try:
            img = first
            for p in frame_paths:
                nxt = cv2.imread(p)
                if nxt is None:
                    raise ValueError(f"unreadable frame: {p}")
                img = nxt
                if img.shape[:2] != (h, w):
                    img = cv2.resize(img, (w, h))
                writer.write(img)
            for _ in range(int(hold_last_s * fps)):  # hold the last frame like the reference
                writer.write(img)
        finally:
            writer.release()  # always flush/close, even when a frame read fails mid-loop
        return video_path
    except Exception:
        # don't leave a truncated container behind for consumers globbing the video
        if os.path.exists(video_path):
            os.remove(video_path)
    try:
        from PIL import Image

        gif = os.path.splitext(video_path)[0] + ".gif"
        frames = [Image.open(p) for p in frame_paths]
        frames[0].save(gif, save_all=True, append_images=frames[1:],
                       duration=int(1000 / fps), loop=0)
        return gif
    except ImportError:
        return None


def trajectory_world_points(
    part_pcs_gt: np.ndarray,  # [P, N, 3] parts in the GT assembled frame
    artifact: dict,
    step: int,
) -> np.ndarray:
    """Pose every part's GT-frame cloud at a trajectory step. -> [P, N, 3] world."""
    traj = artifact["trajectory"][step]  # [P, 7]
    out = np.empty_like(part_pcs_gt)
    for p in range(part_pcs_gt.shape[0]):
        m = compose_render_transform(artifact["init_pose"], artifact["gt"][p], traj[p])
        pts = part_pcs_gt[p]
        out[p] = pts @ m[:3, :3].T + m[:3, 3]
    return out
