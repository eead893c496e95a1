"""eval_p95_ms: 95th percentile of every request's latency in the window,
submission to values ready (gathered, on the sharded cell), in ms."""

import numpy as np


def read(run):
    lat = run["latency_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
