"""The training loop of the port's four trainers (``training/{vqvae,denoiser,verifier}.py``,
``matching/train.py``), which owns their checkpoint, resume and validation policy.

A trainer starts with ``spawned`` and, where it trains in this process, hands its state,
train loader and two callbacks to ``fit``. A producer thread builds the next batch
meanwhile (``prefetch_batches``, restarted every epoch).
"""

from __future__ import annotations

from typing import Callable

from puzzlefusion_plusplus_tpu_torch.data.loader import prefetch_batches
from puzzlefusion_plusplus_tpu_torch.parallel import launch, mesh
from puzzlefusion_plusplus_tpu_torch.training.state import (
    MetricsLogger,
    TopKCheckpointer,
    TrainState,
    maybe_restore,
    save_checkpoint,
)


def spawned(out_dir: str, fresh_state: Callable[[], TrainState], fn: Callable, args: tuple,
            num_devices: int, device, batch_size: int,
            join_timeout_s: float | None) -> TrainState | None:
    """None where this process trains, alone or as its rank; else ``fn(*args)`` ran on
    spawned ranks (``parallel/launch.py::entry``, ``join_timeout_s`` bounding them) and
    -> ``fresh_state()`` restored from the last checkpoint they wrote."""
    if launch.entry(launch.discard_result, (fn, *args), num_devices, device, batch_size,
                    join_timeout_s) is launch.HERE:
        return None
    return maybe_restore(fresh_state(), f"{out_dir}/ckpt")


def fit(state: TrainState, out_dir: str, loader, epochs: int,
        step_fn: Callable[[int, dict], dict],
        validate: Callable[[], tuple[dict, float] | None], topk: dict, every: int,
        log_every: int, max_steps: int | None = None, resume_path: str = "") -> TrainState:
    """Resume ``state`` from ``resume_path`` or the latest checkpoint under
    ``<out_dir>/ckpt``, broadcast rank 0's model and train to ``epochs``, starting at
    epoch ``state.step // steps_per_epoch``. ``step_fn(epoch, batch)`` runs a step on a
    loader batch and returns its metrics, logged to ``<out_dir>/metrics.jsonl`` at the step
    before the update when that is a multiple of ``log_every``; ``max_steps`` stops with a
    checkpoint. Every ``every`` epochs and after the last, ``validate()`` returns (records
    to log, the value that ranks the checkpoint among the top k: ``topk`` holds
    ``TopKCheckpointer``'s arguments but its directory), or None where there were no
    validation batches, and then a plain checkpoint is written."""
    ckpt_dir = f"{out_dir}/ckpt"
    logger = MetricsLogger(out_dir)
    ranked = TopKCheckpointer(ckpt_dir, **topk)
    state = maybe_restore(state, ckpt_dir, resume_path)
    mesh.replicate(state.model)
    steps_per_epoch = max(len(loader), 1)
    for epoch in range(min(state.step // steps_per_epoch, epochs), epochs):
        for batch in prefetch_batches(loader):
            step = state.step
            metrics = step_fn(epoch, batch)
            if step % log_every == 0:
                logger.log(step, epoch=epoch, **metrics)
            if max_steps is not None and state.step >= max_steps:
                save_checkpoint(ckpt_dir, state)
                return state
        if (epoch + 1) % every == 0 or epoch + 1 == epochs:
            result = validate()
            if result is None:
                save_checkpoint(ckpt_dir, state)
            else:
                records, monitored = result
                logger.log(state.step, epoch=epoch, **records)
                ranked.save(state, state.step, monitored)
    return state
