"""``mfu_pct.match``: the traced matcher steps' needed FLOPs (``flops_matcher.py``) over the
traced slice's wall time, in % of the peak. None where the slice holds no
``pfpp.match.step`` span of the program."""

from pfpp_bench.flops import PEAK_FLOPS


def read(r: dict):
    sl = r.get("slice")
    if not sl or sl["span_count"].get("pfpp.match.step", 0) == 0 or not r.get("match_flops"):
        return None
    return 100.0 * r["match_flops"] / sl["wall_s"] / PEAK_FLOPS
