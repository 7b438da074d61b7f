"""``sinkhorn_ms_per_step.match``: device ms of the kernels launched inside the program's
``pfpp.match.sinkhorn`` span (the forward's log-space Sinkhorn) per training step, in the
traced slice. None where the program has no such span."""

from pfpp_bench import readers


def read(r: dict):
    return readers.span_ms(r, "pfpp.match.sinkhorn", "pfpp.match.step")
