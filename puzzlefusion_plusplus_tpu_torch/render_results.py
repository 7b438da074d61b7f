"""Rendering entry point (port of the root ``render_results.py``; reference
renderer/render_results.py). Runs on the host only: it touches no device. It sits beside
``bench.py``, not inside ``renderer/``: there a module of this name would shadow the package's
``render_results`` function once imported.

It reads what ``inference/run.py::save_inference_artifacts`` writes (per sample
``predict_{acc}.npy``, ``gt.npy``, ``init_pose.npy``, ``mesh_file_path.txt``). Two modes:
  * point clouds (matplotlib): ``python -m puzzlefusion_plusplus_tpu_torch.render_results
    inference_dir=output/everyday/inference/results pc_data_dir=pc_data/everyday/val
    [num_samples=4 every=5]``;
  * meshes: the same with ``mesh_root=/path/to/meshes [out_dir=render_out]``: the z-buffer
    rasterizer over the original part meshes (the reference's Blender path), no ``bpy``.
"""

from __future__ import annotations

import os
import sys


def main(argv=None) -> list[str]:
    """-> the files written."""
    argv = sys.argv[1:] if argv is None else argv
    args = dict(a.split("=", 1) for a in argv if "=" in a)
    every = int(args.get("every", 5))
    if "mesh_root" in args:
        from puzzlefusion_plusplus_tpu_torch.renderer import render_mesh_trajectory

        inf_dir = args["inference_dir"]
        samples = sorted(d for d in os.listdir(inf_dir)
                         if os.path.isdir(os.path.join(inf_dir, d)))
        n = int(args.get("num_samples", -1))
        if n > 0:
            samples = samples[:n]
        written = []
        for s in samples:
            written += render_mesh_trajectory(
                os.path.join(inf_dir, s), args["mesh_root"],
                os.path.join(args.get("out_dir", "render_out"), s), every=every)
    else:
        from puzzlefusion_plusplus_tpu_torch.renderer import render_results

        written = render_results(args["inference_dir"], args["pc_data_dir"],
                                 num_samples=int(args.get("num_samples", -1)), every=every)
    print(f"wrote {len(written)} files")
    for w in written[:10]:
        print(" ", w)
    return written


if __name__ == "__main__":
    main()
