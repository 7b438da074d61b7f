"""Denoiser training continued to a deadline, with no plateau gate (port of
``scripts/denoiser_extend.py``).

Continues ``training.denoiser.train`` from the latest checkpoint of a
``synthetic_train_eval`` run root with a large epoch budget. With ``DEADLINE_UTC`` ("HH:MM",
today, UTC) the remaining wall time becomes a step bound (``max_steps``, checked every step,
with a checkpoint at the stop) at 1 step/s, below the 1.38-1.56 steps/s
that the denoiser step at batch 64 takes on an NVIDIA H100 (PERF.md §5), so the final save
lands before the deadline; otherwise the run ends at EPOCHS or is killed (every validation
writes a checkpoint).

``N_TRAIN=4096 EPOCHS=800 BATCH=64 VAL_EVERY=4 [DEADLINE_UTC=HH:MM] BUCKET_MULT=4 python -m
puzzlefusion_plusplus_tpu_torch.scripts.denoiser_extend [--cpu]`` on the run root
``<tmp>/pfpp_torch_gen_<N_TRAIN>``.
"""

from __future__ import annotations

import datetime
import os
import sys

from puzzlefusion_plusplus_tpu_torch.inference.run import resolve_device
from puzzlefusion_plusplus_tpu_torch.scripts import (
    Clock,
    cli_device,
    env_int,
    run_root,
    stage_dir,
    trained_steps,
)
from puzzlefusion_plusplus_tpu_torch.scripts.synthetic_train_eval import gen_config
from puzzlefusion_plusplus_tpu_torch.training import denoiser as tden
from puzzlefusion_plusplus_tpu_torch.training.state import TrainState
from puzzlefusion_plusplus_tpu_torch.utils.config import Config


def step_budget(deadline_utc: str, steps_per_s: float = 1.0,
                now: datetime.datetime | None = None) -> int:
    """The steps that fit before ``deadline_utc`` ("HH:MM" today, UTC) at ``steps_per_s``."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    hh, mm = map(int, deadline_utc.split(":"))
    remaining_s = max((now.replace(hour=hh, minute=mm, second=0, microsecond=0)
                       - now).total_seconds(), 0)
    return int(remaining_s * steps_per_s)


def run(cfg: Config, root: str, epochs: int = 800, batch: int = 64, val_every: int = 4,
        deadline_utc: str = "", bucket_mult: int = 4, device=None) -> TrainState:
    """Continue ``root``'s denoiser at ``cfg``'s widths -> the final train state."""
    device = resolve_device(device)
    clock = Clock()
    cfg = gen_config(root, cfg, bucket_mult)
    cfg.data.batch_size, cfg.data.val_batch_size = batch, 16
    cfg.denoiser.train_on_inference_timesteps = True
    cfg.denoiser.val_every = val_every
    cfg.denoiser.epochs = epochs
    max_steps = None
    if deadline_utc:
        budget = step_budget(deadline_utc)
        start = trained_steps(stage_dir(cfg, "denoiser") + "/ckpt")
        max_steps = start + budget
        clock.say(f"deadline {deadline_utc}Z -> step budget {budget}; resume ~step {start}, "
                  f"max_steps {max_steps}")
    state = tden.train(cfg, max_steps=max_steps, device=device)
    clock.say(f"extension done at step {state.step}")
    return state


def main(argv=None) -> TrainState:
    argv = sys.argv[1:] if argv is None else argv
    device = cli_device(argv)
    return run(Config(), run_root(f"gen_{env_int('N_TRAIN', 4096)}"),
               epochs=env_int("EPOCHS", 800), batch=env_int("BATCH", 64),
               val_every=env_int("VAL_EVERY", 4), deadline_utc=os.environ.get("DEADLINE_UTC", ""),
               bucket_mult=env_int("BUCKET_MULT", 4), device=device)


if __name__ == "__main__":
    main()
