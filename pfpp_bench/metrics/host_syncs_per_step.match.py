"""``host_syncs_per_step.match``: the program's blocking host syncs (its ``pfpp.sync.*``
spans: the batch's copy to the card, the BatchNorms' counts) per matcher training step
(``pfpp.match.step``), in the traced slice. None where the program has no step span."""


def read(r: dict):
    spans = r.get("spans", {})
    steps = spans.get("pfpp.match.step", {}).get("count", 0)
    if not r.get("slice") or steps == 0:
        return None
    return sum(v["count"] for k, v in spans.items() if k.startswith("pfpp.sync.")) / steps
