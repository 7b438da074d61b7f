"""``host_ms_per_step.serve``: host ms of the program's ``pfpp.engine.step`` span (encode,
denoiser, DDPM step and pose composition of one denoising step) per opening, in the traced
slice. None where the program has no such span."""


def read(r: dict):
    if not r.get("slice"):
        return None
    try:
        from puzzlefusion_plusplus_tpu_torch.utils.profiling import snapshot
    except ImportError:  # a program without spans
        return None
    step = snapshot()["spans"].get("pfpp.engine.step")
    if not step or step["count"] == 0:
        return None
    return 1e3 * step["total_s"] / step["count"]
