"""Starts one process a rank for the data-parallel entry points.

The JAX entries use every device of ``trainer.num_devices`` from one command; the port's do
the same by spawning their own workers. Each entry point starts with ``entry``: ``python -m
puzzlefusion_plusplus_tpu_torch.training.vqvae trainer.num_devices=4`` starts four processes,
each of which calls ``train`` again inside a process group (``entry`` then sees the group and
the rank runs on). Under ``torchrun`` the group comes from ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT`` instead (``join_torchrun``), and nothing is
spawned. A world size of 1 stays in the calling process.

Backends: NCCL on ``cuda``, one process a card (``torch.cuda.set_device(local_rank)``); gloo
on the CPU. ``share_card=True`` puts every rank on card 0 over gloo (NCCL refuses two ranks
on one GPU); only a one-card smoke test wants that.

Every group is created with a 60 s timeout, so that a collective one rank skipped fails
instead of hanging; the rendezvous is a ``file://`` store in a fresh temporary directory,
so concurrent launches never race for a TCP port. On ``cuda``, rank 0 builds the kernels
before the others load them (``ops/cuda_build.py``), so W ranks do not start W x 6 ``nvcc``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from puzzlefusion_plusplus_tpu_torch.parallel import mesh

TIMEOUT_S = 60.0
RESULT_FILE = "rank0_result.pt"
HERE = object()  # ``entry``'s answer where the caller itself runs (alone or as its rank)


def backend(device, share_card: bool = False) -> str:
    return "nccl" if torch.device(device).type == "cuda" and not share_card else "gloo"


def needs_spawn(world: int) -> bool:
    """More than one rank asked for, and this process is not one of them yet."""
    return world > 1 and not mesh.initialized()


def join_torchrun(device) -> None:
    """Join the process group that ``torchrun``'s environment describes, once."""
    if mesh.initialized() or "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend(device), init_method="env://",
                            timeout=timedelta(seconds=TIMEOUT_S))
    if torch.device(device).type == "cuda":
        _build_kernels_first(local_rank)


def _build_kernels_first(local_rank: int) -> None:
    """The host's first rank compiles the kernels while the others wait at a barrier."""
    if local_rank == 0:
        from puzzlefusion_plusplus_tpu_torch.ops import cuda_build

        cuda_build.build_all()
    dist.barrier()


def _worker(local_rank: int, fn, args: tuple, world: int, device_type: str, share_card: bool,
            store_dir: str, threads: int):
    if device_type == "cuda":
        torch.cuda.set_device(0 if share_card else local_rank)
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(backend(device_type, share_card),
                            init_method=f"file://{os.path.join(store_dir, 'store')}",
                            world_size=world, rank=local_rank,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        if device_type == "cuda":
            _build_kernels_first(local_rank)
        out = fn(*args)
        if local_rank == 0:
            torch.save(out, os.path.join(store_dir, RESULT_FILE))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def discard_result(fn, *args) -> None:
    """``fn(*args)`` without its return value: a trainer's state stays in its ranks (the
    caller reads the checkpoint they wrote)."""
    fn(*args)


def entry(fn, args: tuple, num_devices: int, device, batch_size: int | None = None,
          join_timeout_s: float | None = None):
    """The start of a data-parallel entry point that ``fn(*args)`` calls again in each rank.
    Joins the group that ``torchrun``'s environment describes, resolves ``num_devices``
    (``mesh.world_size``, which also checks ``batch_size``) and, where more ranks are asked
    for than this process is, runs ``fn(*args)`` on that many new processes -> rank 0's
    result (``run``); else -> ``HERE``: the caller goes on in this process."""
    join_torchrun(device)
    world = mesh.world_size(num_devices, device, batch_size)
    if not needs_spawn(world):
        return HERE
    return run(fn, args, world, device, join_timeout_s=join_timeout_s)


def run(fn, args: tuple, world: int, device, share_card: bool = False,
        join_timeout_s: float | None = None):
    """Call ``fn(*args)`` on ``world`` new processes, ranks of one group; -> rank 0's return
    value (passed back through ``torch.save``, so it should be tensors, numbers, strings
    and containers of them). ``fn`` must be importable by name (a module-level function of
    this package: a spawned process imports it anew). A rank that raises stops the others
    and the error re-raises here; ``join_timeout_s`` (None: no bound) bounds the whole run,
    while the group's collectives time out after ``TIMEOUT_S``. CPU ranks share out this
    process's intra-op threads."""
    device_type = torch.device(device).type
    threads = max(1, torch.get_num_threads() // world)
    store_dir = tempfile.mkdtemp(prefix="pfpp_dist_")
    try:
        ctx = mp.start_processes(
            _worker, args=(fn, args, world, device_type, share_card, store_dir, threads),
            nprocs=world, join=False, start_method="spawn")
        deadline = None if join_timeout_s is None else time.monotonic() + join_timeout_s
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{world} ranks of {getattr(fn, '__name__', fn)} did not "
                                   f"finish within {join_timeout_s} s")
        return torch.load(os.path.join(store_dir, RESULT_FILE), weights_only=False)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
