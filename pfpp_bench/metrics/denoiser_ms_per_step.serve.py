"""``denoiser_ms_per_step.serve``: device ms of the denoiser transformer's forward per
denoising step."""

from pfpp_bench import readers


def read(r: dict):
    return readers.span_ms(r, "denoiser")
