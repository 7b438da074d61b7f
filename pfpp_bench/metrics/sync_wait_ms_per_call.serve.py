"""``sync_wait_ms_per_call.serve``: host ms spent inside the program's host syncs (its
``pfpp.sync.*`` spans) per engine call (``pfpp.engine.call``), in the traced slice. None where
the program has no such spans."""


def read(r: dict):
    if not r.get("slice"):
        return None
    try:
        from puzzlefusion_plusplus_tpu_torch.utils.profiling import snapshot
    except ImportError:  # a program without spans
        return None
    spans = snapshot()["spans"]
    calls = spans.get("pfpp.engine.call", {}).get("count", 0)
    if calls == 0:
        return None
    return 1e3 * sum(v["total_s"] for k, v in spans.items() if k.startswith("pfpp.sync.")) / calls
