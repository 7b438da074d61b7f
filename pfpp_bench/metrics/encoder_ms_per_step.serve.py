"""``encoder_ms_per_step.serve``: device ms of the frozen encoder (span around
extract_features) per denoising step."""

from pfpp_bench import readers


def read(r: dict):
    return readers.span_ms(r, "encoder")
