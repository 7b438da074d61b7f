"""Structural floors of the engine's part_acc on a split (port of
``scripts/part_acc_floor.py``).

part_acc counts the reference parts too, and they are pinned to the GT by construction (the
engine and the reference alike, auto_aggl.py:96-132), so a denoiser that learned nothing
still scores the reference fraction plus what identity or random poses buy on small parts.
This measures those floors on a split with the production metric
(``utils/metrics.py::calc_part_acc``, kernel N on the card):

* ``ref_floor``    — reference parts at the GT, every other part at the identity pose;
* ``random_floor`` — reference parts at the GT, the others at a diffusion-init random pose
  (``default_rng(seed)``, the quaternion normalised).

Read an engine number against these floors: learning happened only above them.

``python -m puzzlefusion_plusplus_tpu_torch.scripts.part_acc_floor [VAL_DIR] [N_SHAPES]
[--cpu]``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.data.datasets import DenoiserDataset
from puzzlefusion_plusplus_tpu_torch.data.loader import Loader
from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device
from puzzlefusion_plusplus_tpu_torch.scripts import cli_device, run_root
from puzzlefusion_plusplus_tpu_torch.utils.metrics import calc_part_acc


def floors(val_dir: str, n_shapes: int | None = None, seed: int = 0, device=None) -> dict:
    """-> {val_dir, n_shapes, ref_part_fraction_mean, ref_floor, random_floor}, the means
    rounded to 4 places."""
    device = resolve_device(device)
    # test mode is the engine's distribution (one reference part; train mode's multi-ref
    # curriculum would raise the floor); train mode without matching data
    match_dir = os.path.join(os.path.dirname(os.path.dirname(val_dir)), "matching_data")
    if os.path.isdir(match_dir):
        ds = DenoiserDataset(val_dir, mode="test", matching_data_path=match_dir)
    else:
        ds = DenoiserDataset(val_dir, mode="train")
    n = len(ds) if n_shapes is None else min(n_shapes, len(ds))
    loader = Loader(ds, batch_size=min(8, n), shuffle=False, drop_last=False, seed=0)
    rng = np.random.default_rng(seed)
    accs = {"ref_floor": [], "random_floor": []}
    ref_frac = []
    seen = 0

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    for batch in loader:
        if seen >= n:
            break
        pts = t(batch["part_pcs"]) * t(batch["part_scale"])[..., None]
        gt = np.concatenate(  # [B, P, 7] trans ++ quat (w, x, y, z), the training target
            [np.asarray(batch["part_trans"], np.float32),
             np.asarray(batch["part_rots"], np.float32)], axis=-1)
        valids = np.asarray(batch["part_valids"], np.float32)
        ref = np.asarray(batch["ref_part"], bool)

        identity = np.zeros_like(gt)
        identity[..., 3] = 1.0
        pred_ref = np.where(ref[..., None], gt, identity)

        noise = rng.normal(size=gt.shape).astype(np.float32)  # the diffusion init x_T
        q = noise[..., 3:]
        noise[..., 3:] = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-8)
        pred_rand = np.where(ref[..., None], gt, noise)

        for name, pred in (("ref_floor", pred_ref), ("random_floor", pred_rand)):
            acc, _, _ = calc_part_acc(pts, t(pred[..., :3]), t(gt[..., :3]), t(pred[..., 3:]),
                                      t(gt[..., 3:]), t(valids))
            accs[name].extend(acc.cpu().numpy().tolist())
        ref_frac.extend((ref.sum(-1) / valids.sum(-1)).tolist())
        seen += gt.shape[0]

    return {
        "val_dir": val_dir, "n_shapes": seen,
        "ref_part_fraction_mean": round(float(np.mean(ref_frac)), 4),
        **{k: round(float(np.mean(v[:n])), 4) for k, v in accs.items()},
    }


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    device = cli_device(argv)
    args = [a for a in argv if a != "--cpu"]
    out = floors(args[0] if args else run_root("gen_4096") + "/pc_data/val",
                 int(args[1]) if len(args) > 1 else None, device=device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
