"""eval.host_ms: mean host time inside ``ScatteredInterp.eval`` per request,
without a synchronise (the facade and dispatch layer's own cost)."""


def read(run):
    spans = run["spans"].get("eval.host")
    return 1e3 * sum(spans) / len(spans) if spans else None
