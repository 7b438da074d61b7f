"""``loader_wait_ms_per_step.train``: host ms the step loop waits on the prefetch iterator per
step."""

from pfpp_bench import readers


def read(r: dict):
    return readers.host_ms(r, "loader_wait")
