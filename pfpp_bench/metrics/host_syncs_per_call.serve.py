"""``host_syncs_per_call.serve``: the program's host syncs (its ``pfpp.sync.*`` spans: exit
checks, merge gates, the results' fetch) per engine call (``pfpp.engine.call``), in the
traced slice. None where the program has no such spans."""


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
    return sum(v["count"] for k, v in spans.items() if k.startswith("pfpp.sync.")) / calls
