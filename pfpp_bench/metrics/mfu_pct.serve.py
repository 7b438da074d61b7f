"""``mfu_pct.serve``: the engine's needed FLOPs of the shapes finished in the traced window, in
% of the peak."""

from pfpp_bench import readers


def read(r: dict):
    return readers.mfu_pct(r)
