"""``encoder_ms_per_step.train``: device ms of the frozen encode in the loss per training
step."""

from pfpp_bench import readers


def read(r: dict):
    return readers.span_ms(r, "encoder", "train_step")
