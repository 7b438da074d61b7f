"""``denoiser_graph_replay_pct.serve``: the share of the denoiser's calls in the traced slice
(the program's ``pfpp.engine.denoiser`` span) that replayed a captured CUDA graph (its
``pfpp.denoiser.replay`` span), in %. None where the program has no ``pfpp.engine.denoiser``
span; 0 where it has that span and replayed nothing."""


def read(r: dict):
    if not r.get("slice"):
        return None
    try:
        from puzzlefusion_plusplus_tpu_torch.utils.profiling import snapshot
    except ImportError:  # a program without spans
        return None
    spans = snapshot()["spans"]
    calls = spans.get("pfpp.engine.denoiser", {}).get("count", 0)
    if calls == 0:
        return None
    return 100.0 * spans.get("pfpp.denoiser.replay", {}).get("count", 0) / calls
