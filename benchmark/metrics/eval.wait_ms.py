"""eval.wait_ms: host time of the program's span
``device_tri.locate_cells.select`` (the ``nonzero`` read of the queries
the walk takes) per traced request, in ms: the host waits there for the
device work queued ahead of the read."""

from benchmark import spans


def read(run):
    v = spans.per_request(run, "device_tri.locate_cells.select", "host_s")
    return 1e3 * v if v is not None else None
