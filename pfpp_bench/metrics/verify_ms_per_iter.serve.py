"""``verify_ms_per_iter.serve``: device ms of the verify pass (span around verify_and_merge)
per engine iteration."""

from pfpp_bench import readers


def read(r: dict):
    return readers.span_ms(r, "verify", "denoise")
