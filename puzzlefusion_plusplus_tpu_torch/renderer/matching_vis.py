"""A copy of ``puzzlefusion_plusplus_tpu/renderer/matching_vis.py`` (numpy only), kept in the
port so that it imports nothing of the JAX package.

Matching-result visualizer (the reference's Jigsaw_matching/vis_results.py capability).

Renders a fracture's pieces in their GT pose with the fracture-surface correspondences drawn
as line segments — the standard way to eyeball matching quality. Headless matplotlib.
"""

from __future__ import annotations

import os

import numpy as np


def render_matching(
    matching_npz_path: str,
    out_path: str | None = None,
    max_lines: int = 300,
) -> str:
    """Render one matching_data .npz (gt_pcs + correspondences) to a PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from puzzlefusion_plusplus_tpu_torch.renderer.pc_renderer import _COLORS

    m = np.load(matching_npz_path, allow_pickle=True)
    gt_pcs = m["gt_pcs"]
    n_pcs = m["n_pcs"].astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(n_pcs)])
    edges = m["edges"].reshape(-1, 2)
    corrs = m["correspondence"]
    critical_idx = m["critical_pcs_idx"].astype(np.int64)
    n_crit = m["n_critical_pcs"].astype(np.int64)

    fig = plt.figure(figsize=(5, 5), dpi=120)
    ax = fig.add_subplot(111, projection="3d")
    for i in range(len(n_pcs)):
        pts = gt_pcs[offsets[i] : offsets[i + 1]]
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1.0,
                   color=_COLORS[i % len(_COLORS)], depthshade=False)

    drawn = 0
    for e in range(len(edges)):
        b, a = int(edges[e, 0]), int(edges[e, 1])  # (idx2, idx1) storage order
        corr = np.asarray(corrs[e]).astype(np.int64).reshape(-1, 2)
        crit_a = critical_idx[offsets[a] : offsets[a] + n_crit[a]]
        crit_b = critical_idx[offsets[b] : offsets[b] + n_crit[b]]
        src = gt_pcs[offsets[a] + crit_a[corr[:, 0]]]
        tgt = gt_pcs[offsets[b] + crit_b[corr[:, 1]]]
        for k in range(len(src)):
            if drawn >= max_lines:
                break
            ax.plot([src[k, 0], tgt[k, 0]], [src[k, 1], tgt[k, 1]],
                    [src[k, 2], tgt[k, 2]], lw=0.3, color="black", alpha=0.4)
            drawn += 1
    ax.set_axis_off()
    out_path = out_path or matching_npz_path.replace(".npz", "_matching.png")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def render_matching_dir(matching_dir: str, out_dir: str | None = None,
                        num_samples: int = -1) -> list[str]:
    files = sorted(f for f in os.listdir(matching_dir) if f.endswith(".npz"))
    if num_samples != -1:
        files = files[:num_samples]
    out_dir = out_dir or matching_dir
    os.makedirs(out_dir, exist_ok=True)
    return [
        render_matching(
            os.path.join(matching_dir, f),
            os.path.join(out_dir, f.replace(".npz", "_matching.png")),
        )
        for f in files
    ]
