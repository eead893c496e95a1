"""walk.idle_ms: the card's idle time inside the program's span
``device_tri.locate`` (the walk fallback) per traced request, in ms."""

from benchmark import spans


def read(run):
    v = spans.per_request(run, "device_tri.locate", "idle_s")
    return 1e3 * v if v is not None and spans.device_traced(run) else None
