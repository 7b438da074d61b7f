"""``host_ms_per_step.match``: host ms of the program's ``pfpp.match.step`` span (one
``train_step``: forward, losses, backward, Adam) per opening, in the traced slice. None
where the program has no such span."""


def read(r: dict):
    step = r.get("spans", {}).get("pfpp.match.step")
    if not r.get("slice") or not step or step["count"] == 0:
        return None
    return 1e3 * step["total_s"] / step["count"]
