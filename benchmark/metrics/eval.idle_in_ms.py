"""eval.idle_in_ms: the card's idle time inside the program's span
``scattered.eval`` (each ``ScatteredInterp.eval``) per traced request, in
ms: the part of the window's idle time that the program's own call spends
(launching, or blocked on a host read), not the harness around it."""

from benchmark import spans


def read(run):
    v = spans.per_request(run, "scattered.eval", "idle_s")
    return 1e3 * v if v is not None and spans.device_traced(run) else None
