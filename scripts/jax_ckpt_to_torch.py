"""Convert one orbax checkpoint of the JAX package into a checkpoint of the PyTorch port.

    python scripts/jax_ckpt_to_torch.py --kind vqvae|denoiser|verifier|matching SRC OUT_CKPT_DIR

SRC is what the JAX package's ``training/state.py::load_checkpoint`` accepts (a ``step_N``
dir, a ckpt dir for its best checkpoint, ``.../best`` or ``.../latest``). The weights go
through ``puzzlefusion_plusplus_tpu_torch/convert/from_jax.py`` and are written as
``OUT_CKPT_DIR/step_N/state.pt`` ({"model": state_dict, "step": N}), which the port's
``*.ckpt_path`` keys load (``training/state.py::load_model_state``). The file carries no
optimizer state: it serves inference and stage handoffs, not a resumed training run.

The only file of the repo that imports both JAX and the port.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from puzzlefusion_plusplus_tpu.training.state import load_checkpoint  # noqa: E402
from puzzlefusion_plusplus_tpu_torch.convert import from_jax  # noqa: E402
from puzzlefusion_plusplus_tpu_torch.training.state import STATE_FILE  # noqa: E402


def state_dict_of(restored: dict, kind: str) -> dict:
    """The port's state_dict of a restored training checkpoint ({params, batch_stats, ...})."""
    tree = jax.tree.map(np.asarray, jax.device_get(restored))
    if kind == "vqvae":
        return from_jax.vqvae_state_dict(tree["params"], tree["batch_stats"])
    if kind == "denoiser":
        return from_jax.denoiser_state_dict(tree["params"])
    if kind == "verifier":
        return from_jax.verifier_state_dict(tree["params"])
    if kind == "matching":
        return from_jax.matching_state_dict(tree["params"], tree["batch_stats"])
    raise ValueError(f"kind must be vqvae, denoiser, verifier or matching, got {kind!r}")


def convert(src: str, out_ckpt_dir: str, kind: str) -> str:
    """Restore ``src``, map it and write ``out_ckpt_dir/step_N/state.pt``. Returns the
    ``step_N`` path."""
    restored = load_checkpoint(src)
    step = int(np.asarray(restored.get("step", 0)))
    path = os.path.abspath(os.path.join(out_ckpt_dir, f"step_{step}"))
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"model": state_dict_of(restored, kind), "step": step},
               os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", required=True, choices=("vqvae", "denoiser", "verifier", "matching"))
    ap.add_argument("src")
    ap.add_argument("out_ckpt_dir")
    args = ap.parse_args(argv)
    print(convert(args.src, args.out_ckpt_dir, args.kind))


if __name__ == "__main__":
    main()
