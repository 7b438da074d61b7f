"""The evaluation scripts (port of the root ``scripts/``'s Python scripts).

Each script is a module named as its counterpart in the root ``scripts/``, with a
``run(cfg, ...)`` that does the work on a ``Config`` and a ``main(argv=None)`` that reads the
JAX script's environment variables, with its defaults, and calls it:
``python -m puzzlefusion_plusplus_tpu_torch.scripts.<name> [--cpu]``.

* ``evidence``            — plateau detection on a ``metrics.jsonl`` and the copy of a run's
                            metrics and summaries into ``chiprun_out/evidence/<tag>/``.
* ``engine_breakdown``    — accuracy tables over an engine's ``breakdown.jsonl``.
* ``part_acc_floor``      — the part_acc a denoiser that learned nothing scores on a split.
* ``overfit_proof``       — all three stages trained on a few shapes, then the engine.
* ``synthetic_train_eval``— the plateau-gated train-and-eval run on held-out shapes.
* ``eval_train_split``    — the best denoiser's sampling metrics on its own training shapes.
* ``rescore_checkpoints`` — a multi-seed re-score of every retained denoiser checkpoint.
* ``denoiser_extend``     — more denoiser epochs from the latest checkpoint, to a deadline.
* ``verifier_regen_eval`` — a verifier trained on data from the trained denoiser, A/B.
* ``matcher_train_eval``  — the matcher on ``synthetic_train_eval``'s shapes: its held-out
                            ``mat_f1`` against the oracle ceiling, its matching data through
                            the engine beside the GT-synthetic data.
* ``matcher_diagnosis``   — a matcher checkpoint under four score/selection regimes.
* ``matching_sensitivity_probe`` — the engine's merges under both kinds of matching data.

The shell scripts beside them are the root ``scripts/``' by name, on the port's entries: the
launchers ``train_{vqvae,denoiser,verifier,matching}.sh`` and ``inference.sh``, and the run
tooling ``supervise_train.sh``, ``stall_watchdog.sh``, ``evidence_queue.sh`` (the root's
``tpu_evidence_queue.sh``), ``warm_cache.sh`` and ``evidence_snapshot.sh``.

The scripts that compute run on ``cuda`` unless given ``--cpu`` (``device="cpu"``), through
``inference/run.py::resolve_device``; ``evidence`` and ``engine_breakdown`` only read and
write files. A run root is ``<tmp>/pfpp_torch_<name>`` (``run_root``): the port's own, never
one of the JAX scripts', whose orbax checkpoints the port cannot read.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device
from puzzlefusion_plusplus_tpu_torch.training.state import latest_checkpoint
from puzzlefusion_plusplus_tpu_torch.utils.config import Config


def run_root(name: str) -> str:
    """``<tmp>/pfpp_torch_<name>``: a script's data, checkpoints and summaries."""
    return os.path.join(tempfile.gettempdir(), f"pfpp_torch_{name}")


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def cli_device(argv: list[str]) -> torch.device:
    """The device of a script's command line: the CPU with ``--cpu``, else ``cuda``, which
    raises without CUDA."""
    return resolve_device("cpu" if "--cpu" in argv else None)


def stage_dir(cfg: Config, stage: str) -> str:
    """Where a trainer of ``cfg`` writes its metrics and ``ckpt/``."""
    return f"{cfg.trainer.output_dir}/{cfg.trainer.experiment_name}/{stage}"


def trained_steps(ckpt_dir: str) -> int:
    """The step of the latest complete checkpoint under ``ckpt_dir`` (0 without one)."""
    path = latest_checkpoint(ckpt_dir)
    return int(path.rsplit("_", 1)[1]) if path else 0


class Clock:
    """Progress lines ``[<s since start>s] <message>``, flushed as they come."""

    def __init__(self):
        self.t0 = time.time()

    def elapsed(self) -> float:
        return time.time() - self.t0

    def say(self, msg: str) -> None:
        print(f"[{self.elapsed():.0f}s] {msg}", flush=True)
