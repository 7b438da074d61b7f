"""``sinkhorn_roofline_pct.match``: the least time of the traced steps' Sinkhorns at the
card's bandwidth (``flops_matcher.sinkhorn_bytes`` of each valid block), in % of the device
time inside the program's ``pfpp.match.sinkhorn`` span. None where the program has no such
span."""

from pfpp_bench.flops import PEAK_BYTES_PER_S


def read(r: dict):
    sl = r.get("slice")
    device_s = sl["span_device_s"].get("pfpp.match.sinkhorn", 0.0) if sl else 0.0
    if device_s <= 0 or not r.get("sinkhorn_bytes"):
        return None
    return 100.0 * r["sinkhorn_bytes"] / PEAK_BYTES_PER_S / device_s
