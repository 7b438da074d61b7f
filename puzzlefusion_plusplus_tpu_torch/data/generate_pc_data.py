"""Preprocessing entry point (port of the root ``generate_pc_data.py``; reference
generate_pc_data.py). Runs on the host only: it touches no device.

Two modes:
  * real meshes: ``python -m puzzlefusion_plusplus_tpu_torch.data.generate_pc_data
    mesh_root=/path/to/breaking_bad out=pc_data/everyday [num_points=1000]``
    (``data/preprocess.py``: each split's fracture meshes through trimesh when installed,
    else ``data/meshio.py``);
  * synthetic: ``python -m puzzlefusion_plusplus_tpu_torch.data.generate_pc_data synthetic=1
    out=/tmp/synth [num_shapes=64 seed=0]`` (``data/synthetic.py``: a train split of
    ``num_shapes`` and a val split of a quarter as many).
"""

from __future__ import annotations

import os
import sys


def main(argv=None) -> list[str]:
    """-> the lines it printed."""
    argv = sys.argv[1:] if argv is None else argv
    args = dict(a.split("=", 1) for a in argv if "=" in a)
    out = args.get("out", "pc_data/everyday")
    lines = []
    if args.get("synthetic"):
        from puzzlefusion_plusplus_tpu_torch.data.synthetic import generate_dataset

        n, seed = int(args.get("num_shapes", 64)), int(args.get("seed", 0))
        generate_dataset(out, num_shapes=n, seed=seed, split="train")
        generate_dataset(out, num_shapes=max(1, n // 4), seed=seed + 1, split="val")
        lines.append(f"wrote synthetic dataset to {out}")
    else:
        from puzzlefusion_plusplus_tpu_torch.data.preprocess import generate_pc_data

        mesh_root = args["mesh_root"]
        for split in ("train", "val"):
            n = generate_pc_data(os.path.join(mesh_root, split), out, split,
                                 num_points=int(args.get("num_points", 1000)))
            lines.append(f"{split}: {n} shapes")
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()
