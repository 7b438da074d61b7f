"""Train state, optimizer, checkpoints and metric logging (port of
``puzzlefusion_plusplus_tpu/training/state.py``).

* Optimizer: ``torch.optim.AdamW`` (eps 1e-8, decay on every parameter, as optax's
  ``adamw``) with ``MultiStepLR`` stepped once per update, so update k (counting from 1)
  runs at ``lr * gamma^#{m : m <= k - 1}`` — the rate ``optax.piecewise_constant_schedule``
  gives at optax's count k - 1. The denoiser's ``adamw_reference`` has no milestones. The
  matcher's ``adam_cosine`` is Adam under ``optax.cosine_decay_schedule``, a closed-form
  ``LambdaLR`` stepped per update.
* Checkpoints: PyTorch's own format. ``<ckpt_dir>/step_N/state.pt`` holds the model's and
  the optimizer's and scheduler's ``state_dict``s and the step; a save writes
  ``step_N.tmp`` and renames it, so an interrupted save never looks complete. Auto-resume,
  top-k retention with smoothed ranking (``topk.json``) and the ``best``/``latest`` aliases
  keep the JAX package's semantics. ``load_model_state`` also reads the original repo's
  Lightning files (``convert/lightning_ckpt.py``).
* Logging: an append-only JSONL stream echoed to stdout.
* Data parallelism: rank 0 alone writes checkpoints, ``topk.json`` and the metrics log, and
  the ranks wait for its checkpoint writes.
"""

from __future__ import annotations

import functools
import json
import math
import os
import shutil
import time
from dataclasses import dataclass

import numpy as np
import torch

from puzzlefusion_plusplus_tpu_torch.convert import lightning_ckpt
from puzzlefusion_plusplus_tpu_torch.parallel import mesh

STATE_FILE = "state.pt"
_TMP = ".tmp"


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def adamw_multistep(model: torch.nn.Module, base_lr: float, milestones_steps, gamma: float = 0.5,
                    weight_decay: float = 1e-6) -> TrainState:
    """The VQ-VAE optimizer: AdamW with MultiStepLR decay at step boundaries."""
    opt = torch.optim.AdamW(model.parameters(), lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.MultiStepLR(opt, [int(m) for m in milestones_steps],
                                                 gamma)
    return TrainState(model, opt, sched, 0)


def adamw_reference(model: torch.nn.Module, lr: float, b1: float = 0.95, b2: float = 0.999,
                    weight_decay: float = 1e-6) -> TrainState:
    """The denoiser's optimizer: AdamW at a constant rate (reference denoiser.py:228-236)."""
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(b1, b2), eps=1e-8,
                            weight_decay=weight_decay)
    return TrainState(model, opt, torch.optim.lr_scheduler.MultiStepLR(opt, []), 0)


def cosine_decay_factor(step: int, decay_steps: int) -> float:
    """``optax.cosine_decay_schedule(1, decay_steps)`` at count ``step``: 0.5 (1 + cos(pi
    min(step, decay_steps) / decay_steps)), in closed form."""
    return 0.5 * (1.0 + math.cos(math.pi * min(step, decay_steps) / decay_steps))


def adam_cosine(model: torch.nn.Module, lr: float, decay_steps: int) -> TrainState:
    """The matcher's optimizer: Adam (0.9, 0.999, eps 1e-8, no weight decay, as
    ``optax.adam``) under a cosine decay to 0 over ``decay_steps`` updates, stepped once per
    update (update k, from 0, at ``lr * cosine_decay_factor(k)``)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, functools.partial(cosine_decay_factor, decay_steps=int(decay_steps)))
    return TrainState(model, opt, sched, 0)


# ---------------------------------------------------------------- checkpointing


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int | None = None) -> str:
    """Write ``step_N/state.pt`` (replacing an older one of that name). Returns the path.
    Inside a process group rank 0 writes and every rank waits for it (the ranks' states are
    equal)."""
    step = int(state.step if step is None else step)
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    if mesh.is_main():
        prune_incomplete_checkpoints(ckpt_dir)
        tmp = path + _TMP
        os.makedirs(tmp)
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "scheduler": state.scheduler.state_dict(), "step": int(state.step)},
                   os.path.join(tmp, STATE_FILE))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    mesh.barrier()
    return path


def _is_complete_checkpoint(path: str) -> bool:
    return (os.path.isdir(path) and not path.rstrip(os.sep).endswith(_TMP)
            and os.path.isfile(os.path.join(path, STATE_FILE)))


def prune_incomplete_checkpoints(ckpt_dir: str) -> None:
    """Delete leftover ``step_N.tmp`` dirs of interrupted saves."""
    if os.path.isdir(ckpt_dir):
        for d in os.listdir(ckpt_dir):
            full = os.path.join(ckpt_dir, d)
            if d.endswith(_TMP) and os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)


def _complete_steps(ckpt_dir: str) -> list[str]:
    if not os.path.isdir(ckpt_dir):
        return []
    return [os.path.join(ckpt_dir, d) for d in os.listdir(ckpt_dir)
            if d.startswith("step_") and _is_complete_checkpoint(os.path.join(ckpt_dir, d))]


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """mtime-latest complete ``step_*`` dir (the reference's auto-resume rule)."""
    cands = _complete_steps(ckpt_dir)
    return max(cands, key=os.path.getmtime) if cands else None


def best_checkpoint(ckpt_dir: str) -> str | None:
    """Best ``step_*`` dir by the persisted ``topk.json``; mtime-latest without one."""
    index_path = os.path.join(ckpt_dir, "topk.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            saved = json.load(f)
        live = {k: v for k, v in saved.get("entries", {}).items()
                if os.path.isdir(os.path.join(ckpt_dir, k))}
        if live:
            pick = (max if saved.get("mode", "max") == "max" else min)(live, key=live.get)
            return os.path.join(ckpt_dir, pick)
    return latest_checkpoint(ckpt_dir)


def resolve_checkpoint_path(path: str) -> str:
    """A ``step_N`` dir, a ckpt dir (its best checkpoint), or ``<ckpt_dir>/best`` /
    ``<ckpt_dir>/latest``."""
    path = os.path.abspath(path)
    base, parent = os.path.basename(path), os.path.dirname(path)
    if base in ("latest", "best"):
        resolved = (latest_checkpoint if base == "latest" else best_checkpoint)(parent)
        return resolved or parent
    if os.path.isdir(path) and not base.startswith("step_"):
        return best_checkpoint(path) or path
    return path


def load_checkpoint(path: str) -> dict:
    """The saved dict of a checkpoint path (see ``resolve_checkpoint_path``), on the CPU."""
    return torch.load(os.path.join(resolve_checkpoint_path(path), STATE_FILE),
                      map_location="cpu", weights_only=True)


def load_model_state(path: str, kind: str | None = None) -> dict:
    """The model ``state_dict`` of one checkpoint, on the CPU: a port checkpoint (see
    ``resolve_checkpoint_path``), or an original-repo Lightning ``.ckpt`` file, whose
    ``kind`` ('vqvae', 'denoiser' or 'verifier') names the module to take
    (``convert/lightning_ckpt.py``). A directory without ``state.pt``, such as an orbax
    checkpoint of the JAX package, raises FileNotFoundError naming the converter."""
    if os.path.isfile(path):
        if kind is None:
            raise ValueError(f"{path}: a Lightning checkpoint needs its kind "
                             "('vqvae', 'denoiser' or 'verifier')")
        return lightning_ckpt.load_file(path, kind)
    resolved = resolve_checkpoint_path(path)
    if not os.path.isfile(os.path.join(resolved, STATE_FILE)):
        raise FileNotFoundError(
            f"{path}: no {STATE_FILE} at {resolved}. An orbax checkpoint of the JAX package "
            "is converted first: python scripts/jax_ckpt_to_torch.py --kind <vqvae|denoiser|"
            "verifier|matching> <orbax step dir> <out ckpt dir>")
    return load_checkpoint(resolved)["model"]


def _restore_into(state: TrainState, saved: dict) -> TrainState:
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.scheduler.load_state_dict(saved["scheduler"])
    state.step = int(saved["step"])
    return state


def maybe_restore(state: TrainState, ckpt_dir: str, explicit_path: str = "") -> TrainState:
    """Auto-resume in place: from ``explicit_path`` or else the mtime-latest complete
    checkpoint of ``ckpt_dir`` (resume means latest even where a top-k index exists). A
    damaged checkpoint found by auto-resume is passed over for the next-newest one; a
    damaged explicit one raises. Returns ``state`` unchanged when nothing exists. Inside a
    process group every rank reads the same files (the trainers then broadcast rank 0's
    model, ``parallel/mesh.py::replicate``)."""
    path = explicit_path or latest_checkpoint(ckpt_dir)
    if not path:
        return state
    if os.path.isdir(path) and not os.path.basename(path).startswith("step_"):
        path = latest_checkpoint(path) or path
    cands = [path] if explicit_path else sorted(
        _complete_steps(ckpt_dir), key=os.path.getmtime, reverse=True)
    for cand in cands:
        try:
            saved = load_checkpoint(cand)
        except Exception as e:  # noqa: BLE001 — a damaged checkpoint must not crash-loop
            if explicit_path:
                raise
            print(f"resume: {cand} unrestorable ({e}); trying older checkpoints", flush=True)
            continue
        print(f"resuming from {cand} (step {saved['step']})", flush=True)
        return _restore_into(state, saved)
    print("resume: no restorable checkpoint; starting fresh", flush=True)
    return state


class TopKCheckpointer:
    """Lightning ModelCheckpoint semantics: keep the top-k checkpoints by a monitored metric
    plus always the newest, pruning the rest. The monitored values persist in
    ``<ckpt_dir>/topk.json``, so retention and ``best_checkpoint`` survive restarts.
    ``smooth_k > 1`` ranks each checkpoint on the trailing mean of the last k raw values;
    the raw values stay in the index under "raw"."""

    def __init__(self, ckpt_dir: str, monitor: str, mode: str = "max", top_k: int = 3,
                 smooth_k: int = 1):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.monitor, self.mode, self.top_k = monitor, mode, top_k
        self.smooth_k = max(1, int(smooth_k))
        self.index_path = os.path.join(self.ckpt_dir, "topk.json")
        self.entries: dict[str, float] = {}
        self.raw: dict[str, float] = {}
        self.history: list[float] = []
        if os.path.exists(self.index_path):
            with open(self.index_path) as f:
                saved = json.load(f)
            if saved.get("monitor") == monitor:
                self.entries = {k: float(v) for k, v in saved["entries"].items()}
                self.raw = {k: float(v) for k, v in saved.get("raw", {}).items()}
                self.history = [float(v) for v in saved.get("history", [])]

    def _write_index(self):
        os.makedirs(self.ckpt_dir, exist_ok=True)
        with open(self.index_path, "w") as f:
            json.dump({"monitor": self.monitor, "mode": self.mode, "entries": self.entries,
                       "raw": self.raw, "history": self.history[-64:],
                       "smooth_k": self.smooth_k}, f)

    def save(self, state: TrainState, step: int, metric_value: float) -> str:
        path = save_checkpoint(self.ckpt_dir, state, step)
        name = os.path.basename(path)
        raw = float(metric_value)
        self.history.append(raw)
        self.raw[name] = raw
        self.entries[name] = (float(np.mean(self.history[-self.smooth_k:]))
                              if self.smooth_k > 1 else raw)
        keep = set(self._ranked()[: self.top_k]) | {name}
        for old in [k for k in self.entries if k not in keep]:
            if mesh.is_main():
                shutil.rmtree(os.path.join(self.ckpt_dir, old), ignore_errors=True)
            del self.entries[old]
            self.raw.pop(old, None)
        if mesh.is_main():
            self._write_index()
        mesh.barrier()
        return path

    def _ranked(self) -> list[str]:
        return sorted(self.entries, key=self.entries.__getitem__, reverse=self.mode == "max")


# ---------------------------------------------------------------- logging


class MetricsLogger:
    """Append-only JSONL metrics stream + stdout echo, written by rank 0 alone inside a
    process group (every rank's metrics are the global batch's)."""

    def __init__(self, out_dir: str, name: str = "metrics"):
        if mesh.is_main():
            os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{name}.jsonl")
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        """Append one record; ``wall_s`` is taken after the values are read, so for device
        tensors it marks the end of the step that produced them."""
        if not mesh.is_main():
            return
        vals = {k: float(v) if isinstance(v, (torch.Tensor, np.ndarray, np.generic)) else v
                for k, v in metrics.items()}
        rec = {"step": int(step), "wall_s": time.time() - self._t0, **vals}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in rec.items()), flush=True)
