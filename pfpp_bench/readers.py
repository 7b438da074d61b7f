"""Arithmetic shared by the per-layer metrics' readers (``metrics/<metric>.py``).

A reader takes the run's readings and returns its number, or None where the run has nothing
for it to read: then the metric is left out of the line. None of them returns 0 for a share
of a peak or a roofline.
"""

from __future__ import annotations

from pfpp_bench.flops import PEAK_BYTES_PER_S, PEAK_FLOPS


def idle_pct(r: dict):
    """The traced slice's wall time minus the union of device intervals, in % of wall."""
    sl = r.get("slice")
    if not sl or sl["wall_s"] <= 0:
        return None
    return 100.0 * (sl["wall_s"] - sl["busy_s"]) / sl["wall_s"]


def mfu_pct(r: dict):
    """The window's needed FLOPs over its seconds, in % of the peak (``flops.py``)."""
    if not r.get("flops") or r.get("window_s", 0) <= 0:
        return None
    return 100.0 * r["flops"] / r["window_s"] / PEAK_FLOPS


def span_ms(r: dict, span: str, per: str | None = None):
    """Device ms of the kernels launched inside ``span`` in the slice, per opening of
    ``per`` (default: of the span itself)."""
    sl = r.get("slice")
    if not sl:
        return None
    count = sl["span_count"].get(per or span, 0)
    if count == 0 or sl["span_device_s"].get(span, 0.0) <= 0:
        return None
    return 1e3 * sl["span_device_s"][span] / count


def roofline_pct(r: dict, span: str, flops_key: str, bytes_key: str):
    """The least time the peaks allow for the span's needed work, in % of its device time."""
    sl = r.get("slice")
    if not sl or sl["span_device_s"].get(span, 0.0) <= 0 or not r.get(flops_key):
        return None
    least = max(r[flops_key] / PEAK_FLOPS, r.get(bytes_key, 0) / PEAK_BYTES_PER_S)
    return 100.0 * least / sl["span_device_s"][span]


def host_ms(r: dict, span: str):
    """Mean host ms of the benchmark's own host span over the window."""
    xs = r.get("host", {}).get(span)
    if not xs:
        return None
    return 1e3 * sum(xs) / len(xs)


def nccl_ms_per_step(r: dict):
    """Device ms of the collective kernels in the slice, per training step."""
    sl = r.get("slice")
    steps = r.get("slice_steps", 0)
    if not sl or steps <= 0 or sl["nccl_s"] <= 0:
        return None
    return 1e3 * sl["nccl_s"] / steps
