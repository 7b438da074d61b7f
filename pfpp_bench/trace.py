"""Spans and the device trace of a traced run.

``Spans`` wraps program functions where their callers look them up, each call inside a
``torch.profiler.record_function`` range named after the layer, and restores them after.
``Slice`` profiles a fixed slice at a window's end with ``torch.profiler``, exports the
Chrome trace into the run's temporary directory and reduces it:

* busy seconds: the union of the device's kernel, copy and set intervals (overlapping
  kernels count once), over the slice's wall time;
* per span: the device seconds of the kernels launched while the span was open on the
  launching thread (matched by the launch's correlation id), and how often the span opened;
* the device operations that took most time, by name;
* the idle gaps between device intervals, each named by the innermost span open on the host
  when the gap began (else "host"), summed by name.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Spans:
    """Named ranges around program functions: ``wrap(owner, attr, name)``."""

    def __init__(self):
        self._saved = []

    def wrap(self, owner, attr: str, name: str) -> None:
        fn = getattr(owner, attr)
        had = attr in vars(owner)

        def spanned(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        self._saved.append((owner, attr, vars(owner).get(attr), had))
        setattr(owner, attr, spanned)

    def restore(self) -> None:
        for owner, attr, old, had in reversed(self._saved):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._saved.clear()


def _union(intervals: list) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


class Slice:
    """A profiled slice: ``with Slice() as sl: ...``, then ``sl.reduce(span_names)``."""

    def __enter__(self):
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def reduce(self, span_names) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.remove(path)
        return reduce_events(events, set(span_names), self.wall_s)


def short_name(name: str) -> str:
    """A kernel's name without its argument list: stable, and short enough for a line."""
    name = name.replace("(anonymous namespace)", "{anonymous}")
    depth = 0
    for k, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and k:
            return name[:k]
    return name


def innermost(spans: list, times: list) -> list:
    """For each (time, ...) of ``times`` (sorted), the name of the latest-started span of
    ``spans`` [(start, end, name)] open at that time, or None."""
    spans = sorted(spans)
    out, open_, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t[0]:
            open_.append(spans[i])
            i += 1
        open_ = [sp for sp in open_ if sp[1] >= t[0]]
        out.append(open_[-1][2] if open_ else None)
    return out


def reduce_events(events: list, span_names: set, wall_s: float) -> dict:
    """The slice's numbers from Chrome-trace events (times in microseconds)."""
    spans = {}  # (pid, tid) -> [(start, end, name)]
    launches = {}  # correlation -> (pid, tid, ts)
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat == "user_annotation" and ev.get("name") in span_names:
            spans.setdefault((ev["pid"], ev["tid"]), []).append((ts, ts + dur, ev["name"]))
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev["pid"], ev["tid"], ts)
        elif cat in DEVICE_CATS:
            device.append(ev)

    span_count = {n: sum(1 for v in spans.values() for _, _, m in v if m == n) for n in span_names}
    span_dev = {n: 0.0 for n in span_names}
    by_name, intervals, queries = {}, [], {}
    for ev in device:
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        intervals.append((ts, ts + dur))
        name = short_name(ev.get("name", "?"))
        by_name[name] = by_name.get(name, 0.0) + dur
        launch = launches.get(ev.get("args", {}).get("correlation"))
        if launch is not None:
            queries.setdefault(launch[:2], []).append((launch[2], dur))
    for key, qs in queries.items():
        for (_, dur), span in zip(sorted(qs), innermost(spans.get(key, []), sorted(qs))):
            if span is not None:
                span_dev[span] += dur
    busy_us = _union(intervals)

    # idle gaps, named by the innermost span open on the host as the gap began
    merged = []
    for s0, e0 in sorted(intervals):
        if merged and s0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e0)
        else:
            merged.append([s0, e0])
    host = [sp for v in spans.values() for sp in v]
    ends = [(e0, s1 - e0) for (_, e0), (s1, _) in zip(merged, merged[1:])]
    gaps = {}
    for (_, length), span in zip(ends, innermost(host, ends)):
        gaps[span or "host"] = gaps.get(span or "host", 0.0) + length

    nccl = sum(v for k, v in by_name.items() if "nccl" in k.lower())
    return {
        "wall_s": wall_s,
        "busy_s": busy_us * 1e-6,
        "span_device_s": {k: v * 1e-6 for k, v in span_dev.items()},
        "span_count": span_count,
        "nccl_s": nccl * 1e-6,
        "device_ops": [[k, v * 1e-6] for k, v in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[k, v * 1e-6] for k, v in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
    }
