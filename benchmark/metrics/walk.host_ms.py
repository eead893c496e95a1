"""walk.host_ms: host time of the program's span ``device_tri.locate``
(the walk fallback, whole) per traced request, in ms."""

from benchmark import spans


def read(run):
    v = spans.per_request(run, "device_tri.locate", "host_s")
    return 1e3 * v if v is not None else None
