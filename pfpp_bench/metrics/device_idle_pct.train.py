"""``device_idle_pct.train``: the device's idle share over the traced slice of training steps
(rank 0)."""

from pfpp_bench import readers


def read(r: dict):
    return readers.idle_pct(r)
