"""Split one batch of ``ScatteredInterp.eval`` on the card into its stages.

Usage, from the root of a checkout, on a machine with a CUDA card:

    python3 -m gsl_scattered_interpolation_torch.profile_eval

It builds chip_smoke.py's headline problem (2,000 sites uniform in
[-0.5, 0.5]^2, T = 4,001, batches of 10^6 float32 queries; ``--sites``
changes it) with ``engine="device"`` and then

1. times each stage of ``device_tri.interp`` alone with CUDA events.  On
   the kernel's route (up to ``DENSE_LOCATE_MAX_TRIS`` simplexes): packing
   the locate tables (done once per triangulation), the locate kernel
   alone (``locate2d_leaves``) and with the weights in its epilogue
   (``locate2d_weights``, what the eval runs), the weights' plain
   version that the epilogue replaced, the domain test, and the response
   gather and sum.  On the cell index's route (past it; e.g. ``--sites 200000``):
   ``locate_cells`` without and with its walk fallback, and the response
   gather and sum;
2. traces a few eval batches with ``torch.profiler`` and prints the ops by
   device time, and the share of the eval's device span in which no
   kernel ran.

The last line of its output is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .models import device_tri
from .models.scattered import NOSTANDARDIZE, ScatteredInterp
from .ops import locate


def _time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_us(evt) -> float:
    """Self device time of a profiler average, in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=1_000_000)
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_eval: no CUDA device", file=sys.stderr)
        return 1

    rng = np.random.default_rng(0)
    sites = rng.uniform(-0.5, 0.5, size=(args.sites, 2))
    values = np.sin(6 * sites[:, 0]) * np.cos(6 * sites[:, 1])
    si = ScatteredInterp(
        sites, values, flags=NOSTANDARDIZE, engine="device", device="cuda"
    )
    tri, response = si.tri, si.response
    cells = si._get_cells()
    gen = torch.Generator(device="cuda").manual_seed(1)
    Q = torch.rand(args.batches, args.batch, 2, generator=gen, device="cuda")
    Q = Q * 0.9 - 0.45
    q = Q[0]

    # 1. Stages of the eval's route, each alone.
    res = {"B": args.batch, "T": tri.n_tris}
    if cells is None:
        res["route"] = "pallas"
        leaf, w = locate.locate_weights_kernel(tri, q)
        stages = {
            "pack_tables": lambda: locate.pack_tables(tri),
            "locate2d_leaves": lambda: locate.locate_dense_kernel(tri, q),
            "locate2d_weights": lambda: locate.locate_weights_kernel(tri, q),
            "weights_plain": lambda: device_tri._weights(tri, leaf, q),
            "in_domain": lambda: device_tri._in_domain(w),
        }
    else:
        res["route"] = "cells"
        walked = device_tri.locate.queries
        leaf, w, _ = device_tri.locate_cells(tri, cells, q)
        res["walked"] = device_tri.locate.queries - walked
        stages = {
            "locate_cells_no_walk": lambda: device_tri.locate_cells(
                tri, cells, q, fallback="none"
            ),
            "locate_cells": lambda: device_tri.locate_cells(tri, cells, q),
        }
    stages["gather_and_sum"] = lambda: torch.sum(
        w * response[tri.tri_verts[leaf]], dim=-1
    )
    res["stage_ms"] = {k: _time_ms(f, args.reps) for k, f in stages.items()}
    res["eval_ms"] = _time_ms(lambda: si.eval(q), args.reps)

    # 2. Profiler trace of whole eval batches.
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(args.batches):
            si.eval(Q[i])
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    avgs = [e for e in prof.key_averages() if _device_us(e) > 0]
    avgs.sort(key=_device_us, reverse=True)
    print(f"{'op':60s} {'calls':>6s} {'device us/batch':>16s}")
    for e in avgs[:15]:
        print(f"{e.key[:60]:60s} {e.count // args.batches:6d} "
              f"{_device_us(e) / args.batches:16.1f}")
    # Only device-side records: an aten op's row repeats its kernels' time.
    busy_ms = sum(
        _device_us(e) for e in avgs
        if e.device_type == torch.autograd.DeviceType.CUDA
    ) / 1e3 / args.batches
    res["traced_wall_ms_per_batch"] = 1e3 * traced_s / args.batches
    if busy_ms > 0:
        res["device_busy_ms_per_batch"] = busy_ms
        res["idle_share_of_eval"] = 1.0 - busy_ms / res["eval_ms"]
    else:  # the profiler saw no device activity
        res["device_busy_ms_per_batch"] = "not measured"
        res["idle_share_of_eval"] = "not measured"
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
