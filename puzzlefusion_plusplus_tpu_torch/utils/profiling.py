"""Tracing and timing helpers (port of ``puzzlefusion_plusplus_tpu/utils/profiling.py``).

The reference times with Lightning's ``profiler: simple`` and CUDA-synchronized timers
(Jigsaw_matching/utils/timer.py). The port's versions:

* ``Timer`` / ``AverageMeter``: wall-clock helpers; ``Timer.stop`` waits for the tensors
  it is given (a CUDA synchronize when any lies on the card) before it reads the clock.
* ``phase_timer``: a context manager timing a named phase, synchronized the same way.
* ``trace``: ``torch.profiler`` around a block, writing a Chrome/Perfetto trace (view it in
  ui.perfetto.dev or TensorBoard) and keeping the profile for ``key_averages()``.
* ``log_compile_time``: first call (which builds the CUDA kernels it launches) against
  steady-state latency.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch


def synchronize(*tensors) -> None:
    """Wait for the card when CUDA is in use (any tensor on it, or none given): its
    launches are asynchronous, so a host clock read before this would time the launch."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return
    leaves = list(_tensors(tensors))
    if not leaves or any(t.is_cuda for t in leaves):
        torch.cuda.synchronize()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class Timer:
    """Device-synchronized stopwatch."""

    def __init__(self):
        self._t0 = None
        self.meter = AverageMeter()

    def start(self):
        synchronize()
        self._t0 = time.perf_counter()

    def stop(self, *tensors) -> float:
        synchronize(*tensors)
        dt = time.perf_counter() - self._t0
        self.meter.update(dt)
        return dt


@contextlib.contextmanager
def phase_timer(name: str, results: dict | None = None):
    """Time the block, the card's queued work included; into ``results[name]`` (an
    ``AverageMeter``) when given, else printed."""
    synchronize()
    t0 = time.perf_counter()
    yield
    synchronize()
    dt = time.perf_counter() - t0
    if results is not None:
        results.setdefault(name, AverageMeter()).update(dt)
    else:
        print(f"[phase] {name}: {dt:.4f}s", flush=True)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU, and CUDA when available): writes
    ``<log_dir>/trace.json`` and yields the profiler, whose ``key_averages()`` the caller may
    read after the block."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    with profile(activities=acts) as prof:
        yield prof
        synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def log_compile_time(fn):
    """Wrap a callable; print its first call's latency (the CUDA kernels it launches are
    built there) and each later call's (steady state), each ended by a synchronize."""
    state = {"calls": 0}

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize(out)
        dt = time.perf_counter() - t0
        tag = "build+run" if state["calls"] == 0 else "steady"
        print(f"[{fn.__name__}] {tag}: {dt:.4f}s", flush=True)
        state["calls"] += 1
        return out

    wrapped.calls = state
    return wrapped
