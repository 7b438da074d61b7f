"""``allreduce_ms_per_step.train``: device ms of the collective kernels per training step on
rank 0."""

from pfpp_bench import readers


def read(r: dict):
    return readers.nccl_ms_per_step(r)
