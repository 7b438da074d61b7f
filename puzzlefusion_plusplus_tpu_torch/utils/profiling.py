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
* ``span`` / ``sync`` / ``snapshot``: the program's own spans at its layer boundaries
  (every name starts with ``pfpp.``). They cost one probe each while no profiler runs. Under
  a profiler (``trace``, or any ``torch.profiler.profile``) each span is also a
  ``record_function`` range, on the profile's clock, and lands in an in-memory registry
  that ``snapshot()`` reads: per name its count, host seconds and self seconds, and the
  span records (name, start, end, parent, request).
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
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


# The probe: whether a profiler runs on the calling thread (about 0.1 us on an x86 server
# CPU, where ``record_function`` costs about 10 us a range even with no profiler running).
# It is thread-local: a thread started while another runs a profiler reads False, and its
# ranges miss the export.
_profiler_enabled = torch._C._autograd._profiler_enabled
MAX_RECORDS = 1 << 16
RECORD_KEYS = ("id", "name", "start", "end", "parent", "request")


class _Registry:
    """The spans of the latest profiled session: it starts afresh at the first probe that
    finds a profiler running after the last probe found none. One per process, so that a
    caller's profiled block (the benchmark's traced slice, an operator's ``trace``) is what
    ``snapshot()`` returns, with no handle passed through the program. Two profiled blocks
    with no probe between them make one session: ``profiling_on()`` called between them
    ends the first."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()  # .stack: this thread's open spans
        self.profiled = False  # what the last probe found
        self.clear()

    def clear(self) -> None:
        self.totals: dict[str, list] = {}  # name -> [count, total_s, self_s]
        self.records: list[tuple] = []
        self.dropped = 0
        self.ids = 0
        self.requests = 0

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_REG = _Registry()


def profiling_on() -> bool:
    """The probe, as the spans read it: whether a profiler runs on this thread. A thread
    that reads it hands the answer to the threads it starts (``span(..., on=)``)."""
    on = _profiler_enabled()
    if on != _REG.profiled:
        with _REG.lock:
            if on and not _REG.profiled:
                _REG.clear()
            _REG.profiled = on
    return on


class _Off:
    """The span while no profiler runs: nothing but the probe that chose it."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def discard(self) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "new_request", "ranged", "range", "id", "parent", "request", "t0",
                 "child_s", "kept")

    def __init__(self, name: str, new_request: bool, ranged: bool):
        self.name, self.new_request, self.ranged = name, new_request, ranged
        self.range, self.child_s, self.kept = None, 0.0, True

    def __enter__(self):
        st = _REG.stack()
        up = st[-1] if st else None
        with _REG.lock:
            self.id = _REG.ids
            _REG.ids += 1
            if self.new_request:
                self.request = _REG.requests
                _REG.requests += 1
            else:
                self.request = up.request if up is not None else None
        self.parent = up.id if up is not None else None
        if self.ranged:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        st.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        st = _REG.stack()
        st.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        dur = t1 - self.t0
        if st:
            st[-1].child_s += dur
        if self.kept:
            with _REG.lock:
                tot = _REG.totals.setdefault(self.name, [0, 0.0, 0.0])
                tot[0] += 1
                tot[1] += dur
                tot[2] += dur - self.child_s
                if len(_REG.records) < MAX_RECORDS:
                    _REG.records.append((self.id, self.name, self.t0, t1, self.parent,
                                         self.request))
                else:
                    _REG.dropped += 1
        return False

    def discard(self) -> None:
        """Leave this opening out of the registry (its range stays in the profile)."""
        self.kept = False


def span(name: str, request: bool = False, on: bool | None = None):
    """A context manager around one layer's work. With no profiler running it does nothing
    beyond the probe. Under one it opens ``torch.profiler.record_function(name)`` and
    records the span (``perf_counter`` start and end, the innermost span open on this thread
    as its parent). ``request=True`` starts a new request id (an engine call, a training
    step), which the spans inside it share. ``on``: the probe's answer read on the thread
    that started this one; such a span is recorded by host clock alone."""
    if on is None:
        return _Span(name, request, True) if profiling_on() else _OFF
    return _Span(name, request, False) if on else _OFF


def sync(name: str, x):
    """A sync the caller makes anyway, as span ``name``: a one-element tensor -> its Python
    value (``item()``), a dict of tensors -> a dict of numpy arrays."""
    with span(name):
        if isinstance(x, torch.Tensor):
            return x.item()
        return {k: v.cpu().numpy() for k, v in x.items()}


def snapshot() -> dict:
    """The latest profiled session: ``spans`` {name: {count, total_s, self_s}} (self: total
    minus the time its child spans on the same thread cover), ``records`` (the first
    ``MAX_RECORDS`` spans to close, dicts of ``RECORD_KEYS``) and ``dropped`` (those past
    it)."""
    with _REG.lock:
        return {"spans": {n: {"count": c, "total_s": t, "self_s": s}
                          for n, (c, t, s) in _REG.totals.items()},
                "records": [dict(zip(RECORD_KEYS, r)) for r in _REG.records],
                "dropped": _REG.dropped}
