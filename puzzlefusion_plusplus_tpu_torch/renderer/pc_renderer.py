"""A copy of ``puzzlefusion_plusplus_tpu/renderer/pc_renderer.py`` (numpy only), kept in the
port so that it imports nothing of the JAX package.

Headless point-cloud renderer for inference trajectories (matplotlib; no Blender needed).

The reference renders with Blender + BlenderToolbox + ffmpeg (renderer/myrenderer.py) — heavy
host-only dependencies that cannot live on a TPU pod image. This module provides the same
capability surface from the saved artifacts alone: per-step frames of the assembling shape,
a summary strip, and an animated GIF (Pillow writer; mp4 via ffmpeg when present). Mesh-based
Blender rendering remains available through renderer/blender.py when ``bpy`` exists.
"""

from __future__ import annotations

import os

import numpy as np

from puzzlefusion_plusplus_tpu_torch.renderer.artifacts import (
    assemble_video,
    load_inference_dir,
    trajectory_world_points,
)

_COLORS = np.array([
    [0.65, 0.34, 0.16], [0.31, 0.48, 0.65], [0.41, 0.67, 0.43], [0.75, 0.31, 0.30],
    [0.58, 0.47, 0.71], [0.47, 0.36, 0.28], [0.85, 0.54, 0.76], [0.50, 0.50, 0.50],
    [0.74, 0.74, 0.13], [0.09, 0.75, 0.81], [0.90, 0.60, 0.20], [0.30, 0.30, 0.70],
    [0.20, 0.60, 0.50], [0.80, 0.40, 0.40], [0.55, 0.65, 0.30], [0.35, 0.25, 0.55],
    [0.65, 0.50, 0.20], [0.25, 0.55, 0.65], [0.70, 0.30, 0.55], [0.45, 0.45, 0.25],
])


def render_frame(ax, world_pts: np.ndarray, lim: float = 0.8):
    P = world_pts.shape[0]
    for p in range(P):
        pts = world_pts[p]
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1.0,
                   color=_COLORS[p % len(_COLORS)], depthshade=False)
    ax.set_xlim(-lim, lim); ax.set_ylim(-lim, lim); ax.set_zlim(-lim, lim)
    ax.set_axis_off()
    ax.view_init(elev=20, azim=45)


def render_trajectory(
    sample_dir: str,
    part_pcs_gt: np.ndarray,  # [P_valid, N, 3] GT-frame part clouds
    out_dir: str | None = None,
    every: int = 5,
    make_gif: bool = True,
) -> list[str]:
    """Render a saved trajectory to PNG frames (+ GIF/mp4). Returns written paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    art = load_inference_dir(sample_dir)
    out_dir = out_dir or os.path.join(sample_dir, "render")
    os.makedirs(out_dir, exist_ok=True)
    T = art["trajectory"].shape[0]
    steps = list(range(0, T, every)) + ([T - 1] if (T - 1) % every else [])
    written = []
    for fi, step in enumerate(steps):
        world = trajectory_world_points(part_pcs_gt, art, step)
        fig = plt.figure(figsize=(4, 4), dpi=120)
        ax = fig.add_subplot(111, projection="3d")
        render_frame(ax, world)
        path = os.path.join(out_dir, f"{fi:04d}.png")
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    # video assembly (reference save_video contract, myrenderer.py:264-284); make_gif=False
    # keeps the frames-only contract (no mp4/GIF written)
    if make_gif:
        video = assemble_video(written, os.path.join(out_dir, "assembly.mp4"))
        if video is not None:
            written.append(video)
    return written


def render_results(
    inference_dir: str,
    pc_data_dir: str,
    num_samples: int = -1,
    every: int = 5,
) -> list[str]:
    """Render all sample dirs under an inference output tree (reference
    renderer/render_results.py entry). Part clouds come from the pc_data .npz files."""
    outs = []
    sample_dirs = sorted(
        d for d in os.listdir(inference_dir)
        if os.path.isdir(os.path.join(inference_dir, d))
    )
    if num_samples != -1:
        sample_dirs = sample_dirs[:num_samples]
    for d in sample_dirs:
        npz = os.path.join(pc_data_dir, f"{int(d):05d}.npz")
        if not os.path.exists(npz):
            continue
        data = np.load(npz, allow_pickle=True)
        valid = data["part_valids"].astype(bool)
        pcs = data["part_pcs_gt"][valid]
        outs += render_trajectory(os.path.join(inference_dir, d), pcs, every=every)
    return outs
