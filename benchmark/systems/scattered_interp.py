"""scattered_interp: ``ScatteredInterp`` (the port's models/scattered.py).

Set-up builds it from the sites and values with the configuration's
flags, engine, precision and ``grid_res``; every request is one
``ScatteredInterp.eval`` of a batch, which routes by
``device_tri.auto_method``: the locate kernel up to 16,384 triangles, the
cell index and the walk fallback above.
"""

from __future__ import annotations

import torch

from gsl_scattered_interpolation_torch.models import device_tri, scattered


def build(config: dict, sites, values, device):
    """The timed entry: a callable from queries [B, dim] to values [B]."""
    si = scattered.ScatteredInterp(
        sites, values, flags=getattr(scattered, config["flags"]),
        engine=config["engine"], dtype=getattr(torch, config["dtype"]),
        grid_res=config["grid_res"], device=device,
    )
    return si.eval


def counters() -> dict:
    """The program's counters that the per-layer metrics read."""
    return {"walk.queries": device_tri.locate.queries, "walk.steps": device_tri.locate.steps}
