"""``batch_build_ms.train``: host ms the prefetch thread takes to build one batch (the
program's ``pfpp.loader.build`` span around the loader's ``next``), in the traced slice. None
where the program has no such span."""


def read(r: dict):
    if not r.get("slice"):
        return None
    try:
        from puzzlefusion_plusplus_tpu_torch.utils.profiling import snapshot
    except ImportError:  # a program without spans
        return None
    build = snapshot()["spans"].get("pfpp.loader.build")
    if not build or build["count"] == 0:
        return None
    return 1e3 * build["total_s"] / build["count"]
