"""``mfu_pct.train``: the training steps' needed FLOPs in the traced window, per card, in % of
the peak."""

from pfpp_bench import readers


def read(r: dict):
    return readers.mfu_pct(r)
