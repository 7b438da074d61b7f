"""``device_idle_pct.serve``: the device's idle share over the traced slice of engine calls."""

from pfpp_bench import readers


def read(r: dict):
    return readers.idle_pct(r)
