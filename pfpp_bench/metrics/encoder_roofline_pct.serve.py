"""``encoder_roofline_pct.serve``: the frozen encoder's needed work at the peaks, in % of
its device time."""

from pfpp_bench import readers


def read(r: dict):
    return readers.roofline_pct(r, "encoder", "encoder_flops", "encoder_bytes")
