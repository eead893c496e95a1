#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Usage, from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout and
holds each kernel against its plain PyTorch version on the card: the locate
kernel's leaves, and the leaves and weights of the eval's route, to the
bit, on two triangulations (and in the structured phase at bench.py's
boundary check and at the largest round of thin_200k's float32 rounds),
with its SASS hot loop read per pair; the flip-candidate kernel at three
states of a 200,000-site device build in float32 and float64.  It then runs that
device build end to end and checks it (structure, local Delaunay, agreement
with scipy), and drives both main paths at the size of bench.py's headline,
each with the launch counters set to 0 just before it: ``ScatteredInterp``
with ``engine="host"`` and with ``engine="device"``, then ``.eval`` on 10
batches of a million queries, checked against the matmul brute force and
against scipy.  Last, the at-scale query path, counted from zero the same
way: ``ScatteredInterp(engine="device")`` of the 200,000 sites (T = 400,001)
builds its cell index on the card and answers 10 batches of a million
float32 queries through ``locate_cells`` and the walk, checked against the
locate kernel forced at that T and against scipy; then one batch through
the float64 build (against scipy at 1e-9), one through 20,000 sites, and,
at four T, the times of the kernel, the cell index and the walk per million
queries and of the index's host and device builds.  Then the build at 1M
(bench.py's build configuration): the flip-candidate kernel against its
plain version on the chunked route's compacted rows, then
``ScatteredInterp(engine="device")`` of 1,000,000 sites in float32, seeded
from Qhull, counted from zero, checked as the 200k build is, with 10
batches of a million queries through its cell index against the locate
kernel and scipy, the cell-scoring kernel against its plain version at
2*10^7 queries of its float32 index (and one eval profiled), the walk
kernel against the loop on the queries it leaves to the walk in 4 such
batches (:func:`walk2d_record`), both kernels' value modes (interp's
route) against interp's torch tail, and the same in float64 with one
batch.  Last, the 3D phase at bench.py's sizes, each
path counted from zero (no kernel is on it):
``ScatteredInterp(engine="cavity")`` of 10,000 sites in float32
(and a salted rebuild) and float64, held against scipy; the 3D cell index
under 10 batches of 2,000,000 queries, against the walk and scipy; and
100,000 sites, with a profiled build.  Last, the RBF phase at bench.py's
sizes, each configuration counted from zero (neither kernel is on it), with
TF32 checked off first: ``rbf_pu.fit`` of 100,000 sites in float32 and
float64 (tps_100k), ``CompactRbf`` of 1,000,000 sites and a steady refit
(wendland_1m), the float32 weights of 4,096 sites and their refinement
against a host float64 solve (weights), ``LocalKriging`` of 100,000 sites
under 10^6 predictions with variances (kriging_100k), and ``RbfInterp``'s
direct thin-plate solve at 8,192 sites beside its pcg solver, then pcg at
50,000 sites (rbf_direct); each with a profiled fit.  Last, the
structured phase, each configuration counted from zero: the GSL family in
float64 on the card against the compiled reference GSL's golden values;
``Interp1D`` of every kind on 10^6 knots under 10^7 queries per
operation and 10^6 integrals, against numpy and scipy (gsl1d_1m);
``Interp2D`` bilinear and bicubic on a 2,048 x 2,048 grid under 10^7
queries (gsl2d_2k); the locate kernel at T ~ 101,000 against
``locate_dense`` on a Qhull import (bench.py's boundary check); the hull,
Voronoi diagram and a save/load round trip of the 200k sites; ``thin`` of
200,000 sites with the device builder in float32 and the Qhull builder in
float64, each held by scipy; and the alpha-shape surface of a 61,000-point
ball.  Every tridiagonal system those inits solved is held against the
plain version of the route it took (partitioned or sequential), on the
card, with both routes timed.  Last, the parallel phase, in a fresh
process that joins a process group of one rank under NCCL, each
configuration counted from zero: ``interp_sharded`` of the headline under
10 batches of a million queries through the locate kernel, and of the 200k
build through its cell index, each bit-equal to ``interp``; the tp-sharded
CG fit of 8,192 Wendland sites against the direct solve (and, read but
not gated, the same fit on two sets of uniform random sites); the sp ring's fit
and matvec on wendland_1m's cell grid against the single-process ones; the
tp-sharded Cholesky at n = 8,192 beside ``torch.linalg.cholesky``; and
``dryrun_multichip``.  Everything is timed.

    python3 chip_smoke.py --cells2d

runs only the cell kernel's record at the 1M phase's index (2*10^7
queries, as in the benchmark's 1M cell).

    python3 chip_smoke.py --walk2d [--seed N]

runs only the walk kernel's record (:func:`walk2d_record`) on the
benchmark's 1M cell (``tri2d_1m.eval``) as its seed N makes it: the 1M
sites' facade and all 16 batches of 2*10^7 queries of its pool.

    python3 chip_smoke.py --parallel-ranks 2 4 [--out records.json]

runs only the parallel phase's configurations, at 2 and then 4 ranks under
NCCL, one card each, each rank's part held against the single-process
function; it needs as many cards as the largest N.

Earlier lines are diagnostics.  The line before the last is one JSON object
with a record for each kernel; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or if any phase
fails, it exits non-zero and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import subprocess
import sys
import time
from fractions import Fraction
from typing import NamedTuple

import numpy as np

N_SITES = 2000          # bench.py headline: T = 2 * 2000 + 1 = 4001
N_SITES_LARGE = 8000    # T = 16001, just under the brute-force limit
N_BUILD = 200_000       # device build at scale: M = 2N + 3 = 400,003 slots
BUILD_SEED = 3
BATCH = 1_000_000
N_BATCHES = 10
N_CHECK = 100_000       # queries held against dense locate and scipy
EVAL_VS_DENSE_MAX = 1e-3   # bench.py's gate between the two locates
EVAL_VS_SCIPY_MAX = 1e-4   # float32 values of O(1)
SCIPY_AGREE_MIN = 0.995    # share of the f32 build's data triangles in scipy's
EVAL_VS_SCIPY_F64_MAX = 1e-9  # the JAX package's float64 tolerance
LEAF_MISMATCH_MAX = 0.01   # bench.py's boundary check against the kernel
N_SCALE_SMALL = 20_000     # T = 40,001
N_1M = 1_000_000           # bench.py's build: default_rng(7), grid_res 512
SEED_1M = 7
GRID_RES_1M = 512
# The 3D phase, at bench.py's sizes (bench_cavity3d): cavity3d_10k,
# queries_3d and cavity3d_100k.
N_3D = 10_000
SEED_3D = 13
N_3D_CHECK = 20_000        # queries held against scipy
Q3D_BATCH = 2_000_000
Q3D_SEED = 14
N_3D_LARGE = 100_000
SEED_3D_LARGE = 17
# H100 SXM data sheet: 67 TFLOP/s float32 and 34 TFLOP/s float64 outside
# the tensor cores count an FMA as two operations, so one non-FMA
# instruction per lane and clock is 33.5e12 (float32) and 17e12 (float64)
# per s.
F32_OPS_PER_S = 33.5e12
F64_OPS_PER_S = 17e12
HBM_BYTES_PER_S = 3.35e12
LOCATE_OPS_PER_PAIR = 13   # 4 mul, 4 add, 2 sub, 2 min, 1 compare
LOCATE_WEIGHT_OPS = 12    # per query: 2 sub, 4 mul, 5 add, 1 sub (its weights)
CELLS_BATCH = 20_000_000  # the cell kernel's record: the 1M cell's batch (eval_20m)
CELLS_SEED = 9
WALK_SEED = 2147521001     # the walk kernel's record: a seed of the 1M cell
WALK_BATCHES = 4           # batches of CELLS_BATCH queries in the 1M phase's walk record
WALK_STEPS = 32            # locate_cells' fallback_steps
WALK_BYTES_IN = 20         # per walked query: its row of idx, q and hint
WALK_BYTES_STEP = 36       # per step: the simplex's 32 B affine row, one 4 B neighbour entry
WALK_BYTES_LAST = 32       # per walk cut at max_steps: the last simplex's affine row
WALK_BYTES_OUT = 21        # leaf, weights, in_domain
WALK_BYTES_VALUE = 20      # value mode: the value out, the simplex's 16 B response row in
CELLS_BYTES_OUT = 22       # leaf 8, weights 12, in_domain 1, bad 1
CELLS_BYTES_VALUE = 21     # value mode: value 4 and bad 1 out, the leaf's 16 B response row in
SLEEP_CYCLES = 50_000_000  # about 25 ms of the card's clock: kernel_ms


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def headline_values(sites):
    """bench.py's test function at ``sites``."""
    return np.sin(6 * sites[:, 0]) * np.cos(6 * sites[:, 1])


def headline_problem(n_sites: int, seed: int):
    """Sites uniform in [-0.5, 0.5]^2 and bench.py's test function."""
    sites = np.random.default_rng(seed).uniform(-0.5, 0.5, size=(n_sites, 2))
    return sites, headline_values(sites)


def uniform_queries(n: int, seed: int, device, batches: int = 1):
    """[batches, n, 2] float32 queries uniform in [-0.45, 0.45]^2."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.rand(batches, n, 2, generator=gen, device=device)
    return q * 0.9 - 0.45


def host_triangulation(n_sites: int, seed: int, device):
    """The port's host build of a headline problem, float32 on ``device``."""
    import torch

    from gsl_scattered_interpolation_torch.models import device_tri, host_tree

    sites, _ = headline_problem(n_sites, seed)
    tree = host_tree.build(sites, flags=host_tree.NOSTANDARDIZE)
    return device_tri.freeze(tree, grid_res=128, device=device).cast(
        torch.float32
    )


def device_triangulation(n_sites: int, seed: int, device):
    """The port's device build of a headline problem, float32 on ``device``."""
    import torch

    from gsl_scattered_interpolation_torch.models import device_delaunay as dd
    from gsl_scattered_interpolation_torch.models import host_tree

    sites, _ = headline_problem(n_sites, seed)
    tri, _ = dd.triangulate(
        sites, flags=host_tree.NOSTANDARDIZE, dtype=torch.float32,
        grid_res=128, device=device,
    )
    return tri.cast(torch.float32)


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

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


def kernel_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of ``fn``, a kernel launch, by CUDA
    events around ``reps`` calls that the host queues while the card
    sleeps: so the card runs them back to back, where :func:`time_ms`
    also carries the host's cost of each call whenever that exceeds the
    kernel's.  Fails if the host took longer to queue them than the card
    slept."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued_ms = 1e3 * (time.perf_counter() - t0)
    ev[2].record()
    torch.cuda.synchronize()
    slept_ms = ev[0].elapsed_time(ev[1])
    require(queued_ms < slept_ms,
            f"queueing took {queued_ms:.3f} ms, the card slept {slept_ms:.3f} ms")
    return ev[1].elapsed_time(ev[2]) / reps


def locate_bound_ms(n_q: int, n_t: int, weights: bool = False):
    """(least ms, "operations" or "bytes") for the locate of n_q x n_t,
    and with ``weights`` for the weights of each query's leaf as well."""
    ops = LOCATE_OPS_PER_PAIR * n_q * n_t
    # queries in (8 B) and leaves out (4 B) once, the tables (24 B) once
    n_bytes = 12 * n_q + 24 * n_t
    if weights:
        # Per query: its leaf's affine row in (32 B), its weights out (12 B).
        ops += LOCATE_WEIGHT_OPS * n_q
        n_bytes += 44 * n_q
    ops_ms = 1e3 * ops / F32_OPS_PER_S
    bytes_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def cells2d_bound_ms(n_q: int, K: int, values: bool = False) -> float:
    """Least ms for the cell kernel on n_q queries: each query's 8 B, its
    7K * 4 B candidate row, its leaf's 32 B affine row and 1 B of overflow
    read once, and 22 B of results (leaf 8, weights 12, two flags)
    written; in value mode the leaf's 16 B response row read and 5 B
    (value, walk flag) written instead."""
    tail = CELLS_BYTES_VALUE if values else CELLS_BYTES_OUT
    return 1e3 * n_q * (8 + 28 * K + 32 + 1 + tail) / HBM_BYTES_PER_S


def cells2d_record(si, n_q: int = CELLS_BATCH):
    """The cell kernel against its plain version at ``n_q`` float32 queries
    on the facade ``si``'s cell index: leaf, weights, in_domain and the walk
    mask to the bit; the kernel's time by events and its device time, its
    bound, the plain version's time on the card.  Its value mode
    (``value_mode``): the values and the walk mask against the plain
    version's leaf, weights and in_domain under interp's torch tail, to the
    bit, its times and bound.  One ``si.eval`` counted from zero (one
    launch, one fused eval) and one profiled, with the device time of its
    kernels by name."""
    import torch

    from gsl_scattered_interpolation_torch.models import device_tri
    from gsl_scattered_interpolation_torch.ops import cells as cells_ops

    tri, cells = si.tri, si._get_cells()
    rows = device_tri.vertex_responses(tri, si.response)
    q = uniform_queries(n_q, seed=CELLS_SEED, device="cuda")[0]
    args = (q, tri.shift, tri.scale, cells.table, cells.overflow, tri.affine,
            cells.res, cells.k, cells.complete)

    def launch():
        return cells_ops.cells2d_cuda(*args)

    def plain():
        return device_tri._locate_cells_score_2d(tri, cells, q)

    got, want = launch(), plain()
    torch.cuda.synchronize()
    names = ("leaf", "w", "in_domain", "bad")
    rec = {"B": n_q, "G": cells.res, "K": cells.k, "T": tri.n_tris,
           "table_MB": cells.table.numel() * 4 / 1e6, "complete": cells.complete,
           "mismatches": {k: int((g != p).reshape(n_q, -1).any(-1).sum())
                          for k, g, p in zip(names, got, want)},
           "bad_share": float(got[3].float().mean())}
    del got, want
    rec["ms"] = time_ms(launch, 10)
    rec["device_ms"] = kernel_ms(launch)
    rec["plain_ms"] = time_ms(plain, 2)
    rec["bound_ms"], rec["bound_by"] = cells2d_bound_ms(n_q, cells.k), "bytes"
    rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]

    def launch_values():
        return cells_ops.cells2d_cuda(*args, values=rows)

    (vals, bad), (leaf, w, ok, pbad) = launch_values(), plain()
    want = torch.where(ok, torch.sum(w * si.response[tri.tri_verts[leaf]], dim=-1), 0.0)
    torch.cuda.synchronize()
    value = {"mismatches": _bit_mismatches(("vals", "bad"), (vals, bad), (want, pbad))}
    del vals, bad, leaf, w, ok, pbad, want
    value["ms"] = time_ms(launch_values, 10)
    value["device_ms"] = kernel_ms(launch_values)
    value["bound_ms"] = cells2d_bound_ms(n_q, cells.k, values=True)
    value["bound_share"] = value["bound_ms"] / value["device_ms"]
    value["slower_ms"] = value["device_ms"] - rec["device_ms"]
    rec["value_mode"] = value
    cells_ops.cells2d_cuda.launches = 0
    fused = device_tri.interp.fused_evals
    si.eval(q)
    torch.cuda.synchronize()
    rec["launches_per_eval"] = cells_ops.cells2d_cuda.launches
    rec["fused_per_eval"] = device_tri.interp.fused_evals - fused
    busy_ms, wall_ms, rows = profile_build(lambda: si.eval(q))
    top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:8]
    rec["eval"] = {"busy_ms": busy_ms, "wall_ms": wall_ms,
                   "top_kernels_ms": {k[:80]: ms for k, (_, ms) in top}}
    # Late in a long process the profiler can miss this library's kernel
    # (it has missed locate2d's too): recorded, not gated; the counter gates.
    kernel = [v for k, v in rows.items() if "cells2d_kernel" in k]
    rec["eval"]["kernel_profiled_ms"] = kernel[0][1] if kernel else None
    log(f"cells2d kernel vs plain: {json.dumps(rec)}")
    require(not any(rec["mismatches"].values()), f"cells2d disagrees with its plain version: {rec}")
    require(not any(value["mismatches"].values()),
            f"cells2d's value mode disagrees with the plain version and interp's tail: {value}")
    require(rec["launches_per_eval"] == 1, f"{rec['launches_per_eval']} cells2d launches an eval")
    require(rec["fused_per_eval"] == 1, f"{rec['fused_per_eval']} fused evals an eval")
    return rec


def _bit_mismatches(names, got, want) -> dict:
    """{name: rows of got and want that differ in any bit}."""
    import torch

    out = {}
    for name, g, p in zip(names, got, want):
        if g.dtype == torch.float32:
            g, p = g.view(torch.int32), p.view(torch.int32)
        out[name] = int((g != p).reshape(len(g), -1).any(-1).sum())
    return out


def walk2d_bound_ms(n: "torch.Tensor", max_steps: int, values: bool = False) -> float:
    """Least ms for the walk kernel on queries whose iteration counts are
    ``n`` (``max_steps + 1`` for a walk cut at the cap): each query's
    index, coordinates and hint read and its results written once (in
    value mode its value written and its simplex's response row read),
    then per step its simplex's affine row and the one neighbour entry it
    steps across, and for a cut walk the affine row of the simplex it
    ends on."""
    steps = int(n.clamp(max=max_steps).sum())
    cut = int((n > max_steps).sum())
    out = WALK_BYTES_VALUE if values else WALK_BYTES_OUT
    n_bytes = (len(n) * (WALK_BYTES_IN + out) + WALK_BYTES_STEP * steps
               + WALK_BYTES_LAST * cut)
    return 1e3 * n_bytes / HBM_BYTES_PER_S


def _emulation():
    """``tests/walk2d_emulation.py``, the walk kernel's per-query arithmetic
    in numpy (a helper of the tests, not a package module)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tests" / "walk2d_emulation.py"
    spec = importlib.util.spec_from_file_location("walk2d_emulation", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def walk2d_record(si, pool, max_steps: int = WALK_STEPS):
    """The walk kernel against the loop (its plain version) on every batch
    of ``pool`` [P, B, 2] at the facade ``si``'s cell index: on the
    queries the cell kernel leaves to the walk, leaf, weights and
    in_domain to the bit, and the loop's steps against the kernel's
    count; and interp's values by the fused route (both kernels' value
    modes) against ``locate_cells`` and interp's torch tail, to the bit.
    On the first batch: the per-query emulation
    (``tests/walk2d_emulation.py``) against the kernel, each query's
    iterations, the kernel's time by events and its device time, its byte
    bound, the loop's time, and the same times and bound of the value
    mode.  Then, on every batch, one ``si.eval`` counted from zero (one
    walk launch, at most 2 host reads, one fused eval); three timings, in
    turns, of the evals as they run, of the evals without the host read
    of the kernel's iteration count (``locate.steps`` left stale), and of
    the evals by ``locate_cells`` and interp's torch tail (the route
    before the value modes); and one eval profiled."""
    import torch

    from gsl_scattered_interpolation_torch.models import device_tri
    from gsl_scattered_interpolation_torch.ops import cells as cells_ops
    from gsl_scattered_interpolation_torch.ops import walk as walk_ops

    tri, cells = si.tri, si._get_cells()
    rows = device_tri.vertex_responses(tri, si.response)
    names = ("leaf", "w", "in_domain")
    rec = {"B": pool.shape[1], "batches": [], "T": tri.n_tris, "max_steps": max_steps}

    def plain_eval(q):
        """interp's values by locate_cells and its torch tail."""
        leaf, w, ok = device_tri.locate_cells(tri, cells, q)
        return torch.where(ok, torch.sum(w * si.response[tri.tri_verts[leaf]], dim=-1), 0.0)

    for q in pool:
        leaf, w, ok, bad = cells_ops.cells2d_cuda(q, tri.shift, tri.scale, cells.table,
                                                  cells.overflow, tri.affine, cells.res,
                                                  cells.k, cells.complete)
        idx = torch.nonzero(bad)[:, 0]
        args = (q, idx, tri.shift, tri.scale, cells.hint, cells.res, tri.tri_nbrs,
                tri.affine, max_steps)
        got = [t.clone() for t in (leaf, w, ok)]
        want = [t.clone() for t in (leaf, w, ok)]
        n_max = int(walk_ops.walk2d_cuda(*args, *got))
        steps = device_tri.locate.steps
        device_tri._walk_in_loop(tri, cells, q, idx, max_steps, *want)
        loop_steps = device_tri.locate.steps - steps
        fused = device_tri.interp_cells_on_card(tri, rows, q, cells)
        plain_vals = plain_eval(q)
        rec["batches"].append({
            "walked": idx.numel(), "n_max": n_max,
            "steps": device_tri.lockstep_steps(n_max, max_steps),
            "loop_steps": loop_steps,
            "mismatches": _bit_mismatches(names, got, want),
            "value_mismatches": _bit_mismatches(("vals", "walked_vals"),
                                                (fused, fused[idx]),
                                                (plain_vals, plain_vals[idx]))})
        del fused, plain_vals
        if len(rec["batches"]) == 1:
            first = (q, idx, args, got, leaf, w, ok)
    q, idx, args, got, leaf, w, ok = first
    _, cid = device_tri._cells_of(tri, cells.res, q[idx])
    t0 = time.perf_counter()
    emulated = _emulation().walk2d_plain(q[idx], cells.hint[cid], tri.tri_nbrs, tri.affine,
                                         max_steps)
    rec["emulation_s"] = time.perf_counter() - t0
    rec["emulation_mismatches"] = _bit_mismatches(names, [g[idx].cpu() for g in got],
                                                  emulated[:3])
    n = emulated[3]
    rec["iterations"] = {"mean": float(n.double().mean()), "max": int(n.max()),
                         "histogram": torch.bincount(n).tolist()}
    scratch = [t.clone() for t in (leaf, w, ok)]
    rec["ms"] = time_ms(lambda: walk_ops.walk2d_cuda(*args, *scratch), 20)
    rec["device_ms"] = kernel_ms(lambda: walk_ops.walk2d_cuda(*args, *scratch))
    loop_out = [t.clone() for t in (leaf, w, ok)]
    rec["plain_ms"] = time_ms(
        lambda: device_tri._walk_in_loop(tri, cells, q, idx, max_steps, *loop_out), 5)
    rec["bound_ms"], rec["bound_by"] = walk2d_bound_ms(n, max_steps), "bytes"
    rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
    values = (rows, torch.zeros(len(q), device=q.device))
    value = {"ms": time_ms(lambda: walk_ops.walk2d_cuda(*args, None, None, None,
                                                        values=values), 20),
             "device_ms": kernel_ms(lambda: walk_ops.walk2d_cuda(*args, None, None, None,
                                                                 values=values)),
             "bound_ms": walk2d_bound_ms(n, max_steps, values=True)}
    value["bound_share"] = value["bound_ms"] / value["device_ms"]
    rec["value_mode"] = value
    del values

    reads = lambda: device_tri.locate.host_reads + device_tri.locate_cells_host_reads  # noqa: E731
    walk_ops.walk2d_cuda.launches = 0
    before, fused = reads(), device_tri.interp.fused_evals
    for qb in pool:
        si.eval(qb)
    torch.cuda.synchronize()
    rec["launches_per_eval"] = walk_ops.walk2d_cuda.launches / len(pool)
    rec["host_reads_per_eval"] = (reads() - before) / len(pool)
    rec["fused_per_eval"] = (device_tri.interp.fused_evals - fused) / len(pool)

    def evals():
        for qb in pool:
            si.eval(qb)

    def walk_without_read(tri, cells, q_raw, idx, max_steps, leaf, w, in_domain,
                          values=None):
        walk_ops.walk2d_cuda(q_raw, idx, tri.shift, tri.scale, cells.hint, cells.res,
                             tri.tri_nbrs, tri.affine, max_steps, leaf, w, in_domain,
                             values=values)

    def evals_with(walk):
        device_tri._walk_2d_on_card = walk
        try:
            return time_ms(evals, 2) / len(pool)
        finally:
            device_tri._walk_2d_on_card = kernel_walk

    def plain_evals():
        for qb in pool:
            plain_eval(qb)

    kernel_walk = device_tri._walk_2d_on_card
    rec["eval_ms"], rec["eval_ms_no_read"], rec["eval_ms_plain_tail"] = [], [], []
    for _ in range(3):
        rec["eval_ms"].append(evals_with(kernel_walk))
        rec["eval_ms_no_read"].append(evals_with(walk_without_read))
        rec["eval_ms_plain_tail"].append(time_ms(plain_evals, 2) / len(pool))
    busy_ms, wall_ms, rows = profile_build(lambda: si.eval(pool[0]))
    top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:8]
    rec["eval"] = {"busy_ms": busy_ms, "wall_ms": wall_ms,
                   "top_kernels_ms": {k[:80]: ms for k, (_, ms) in top}}
    kernel = [v for k, v in rows.items() if "walk2d_kernel" in k]
    rec["eval"]["kernel_profiled_ms"] = kernel[0][1] if kernel else None
    log(f"walk2d kernel vs loop: {json.dumps(rec)}")
    bad = [b for b in rec["batches"]
           if any(b["mismatches"].values()) or b["steps"] != b["loop_steps"]]
    require(not bad, f"walk2d disagrees with the loop: {bad}")
    bad = [b for b in rec["batches"] if any(b["value_mismatches"].values())]
    require(not bad, f"the fused route disagrees with interp's tail: {bad}")
    require(not any(rec["emulation_mismatches"].values()),
            f"walk2d disagrees with its per-query emulation: {rec['emulation_mismatches']}")
    require(rec["launches_per_eval"] == 1, f"{rec['launches_per_eval']} walk2d launches an eval")
    require(rec["host_reads_per_eval"] <= 2, f"{rec['host_reads_per_eval']} host reads an eval")
    require(rec["fused_per_eval"] == 1, f"{rec['fused_per_eval']} fused evals an eval")
    return rec


def candmath_bound_ms(n_rows: int, double: bool):
    """(least ms, "operations" or "bytes") for the verdicts of n_rows rows.

    In float32 every operation takes one issue slot.  In float64 the float
    operations run on the FP64 pipe while the integer and select ones
    issue beside them, so the larger of the two times bounds it."""
    from gsl_scattered_interpolation_torch.ops import candmath

    edges = 3 * n_rows
    fl, other = candmath.FLOAT_OPS_PER_EDGE, candmath.OTHER_OPS_PER_EDGE
    ops_s = edges * (fl + other) / F32_OPS_PER_S
    if double:
        ops_s = max(ops_s, edges * fl / F64_OPS_PER_S)
    ops_ms = 1e3 * ops_s
    # Per row: apex and far coordinates (12 values), ids and far ids
    # (24 B), three masks (7 B) in; verdicts (3 B) out.
    fb = 8 if double else 4
    bytes_ms = 1e3 * n_rows * (12 * fb + 24 + 7 + 3) / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def sass_listing(name: str) -> dict:
    """{function: [(address, opcode, operands)]} of the built library of
    ``csrc/<name>.cu``, from ``cuobjdump -sass``."""
    import os

    from gsl_scattered_interpolation_torch.kernels import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    return parse_sass(subprocess.run(
        [tool, "-sass", str(build.library_path(name))],
        capture_output=True, text=True, timeout=120, check=True,
    ).stdout)


def parse_sass(sass: str) -> dict:
    """{function: [(address, opcode, operands)]} of ``cuobjdump -sass``'s
    output."""
    import re

    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9]*)([^;]*);", line)
        if fn and m:
            out[fn].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return out


def sass_counts(name: str) -> dict:
    """Instructions of each kernel instance of the candidate kernel
    (``kernel<float>``, ``kernel<double>``), by opcode: what the compiled
    kernel issues per thread, beside the count of its bound."""
    import re

    counts = {}
    for fn, instrs in sass_listing(name).items():
        m = re.search(r"kernelI([fd])E", fn)
        if m:
            ops = counts[{"f": "float", "d": "double"}[m.group(1)]] = {}
            for _, op, _ in instrs:
                ops[op] = ops.get(op, 0) + 1
    return counts


def sass_inner_loop(instrs) -> dict:
    """The hot loop of a kernel's SASS: of the innermost loops (a backward
    branch and its target, with no other loop inside), the one with the
    most FMUL.  At 4 FMUL per (query, triangle) pair of the locate kernel,
    its instructions per pair, beside the bound's 13."""
    import re

    loops = []
    for addr, op, rest in instrs:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if op == "BRA" and m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(a, b) for a, b in loops
             if not any((a, b) != (c, d) and a <= c and d <= b for c, d in loops)]
    best = None
    for a, b in inner:
        ops = {}
        for addr, op, _ in instrs:
            if a <= addr <= b:
                ops[op] = ops.get(op, 0) + 1
        if ops.get("FMUL", 0) and (best is None or ops["FMUL"] > best["ops"]["FMUL"]):
            best = {"ops": ops, "instructions": sum(ops.values())}
    require(best is not None, "no loop with FMUL in the SASS")
    pairs = best["ops"]["FMUL"] / 4
    best["pairs"] = pairs
    best["per_pair"] = best["instructions"] / pairs
    best["per_pair_by_op"] = {op: n / pairs for op, n in sorted(best["ops"].items())}
    return best


def locate_sass() -> dict:
    """{kernel instance: {instructions, its hot loop per pair}} of the
    locate kernel, logged."""
    out = {}
    for fn, instrs in sass_listing("locate2d").items():
        rec = {"instructions": len(instrs)}
        if "locate2d_kernel" in fn:
            rec["inner_loop"] = sass_inner_loop(instrs)
        out[fn] = rec
        log(f"sass locate2d {fn}: {json.dumps(rec)}")
    require(any("inner_loop" in r for r in out.values()), f"no sweep kernel: {sorted(out)}")
    return out


def locate_call_record(call):
    """One call of a locate wrapper, counted and profiled: the wrapper
    calls and CUDA kernels that its counters saw, the sweep and merge
    kernels that ``torch.profiler`` saw (which must agree with them), the
    sweep's grid (its y extent is the number of slices) and each kernel's
    device ms."""
    from gsl_scattered_interpolation_torch.ops import locate

    counted = locate.locate2d_cuda
    calls, kernels = counted.launches, counted.kernel_launches
    events, _ = device_events(call)
    calls, kernels = counted.launches - calls, counted.kernel_launches - kernels
    sweeps = [e for e in events if "locate2d_kernel" in e["name"]]
    merges = [e for e in events if "locate2d_merge" in e["name"]]
    require(calls == 1 and len(sweeps) == 1,
            f"one call: {calls} wrapper calls, {len(sweeps)} sweep kernels; "
            f"the profiler saw {sorted(e['name'][:60] for e in events)}")
    grid = [int(n) for n in sweeps[0]["args"]["grid"]]
    rec = {"kernels_per_call": kernels, "sweep_kernels": len(sweeps),
           "merge_kernels": len(merges), "slices": grid[1], "sweep_grid": grid,
           "sweep_profiled_ms": float(sweeps[0]["dur"]) / 1e3,
           "merge_profiled_ms": sum(float(e["dur"]) for e in merges) / 1e3}
    require(kernels == len(sweeps) + len(merges) and len(merges) == (grid[1] > 1),
            f"the counter and the profiler disagree: {rec}")
    return rec


def locate_calls_main(paths) -> int:
    """In a fresh process: :func:`locate_call_record` of the leaf call and
    the weights call of the locate wrapper on the inputs saved at each of
    ``paths`` (the arguments ``locate_dense_kernel`` and
    ``locate_weights_kernel`` pass it), printed as one JSON line."""
    import torch

    from gsl_scattered_interpolation_torch.ops import locate

    out = []
    for path in paths:
        q, g, b, centre, affine = (t.cuda() for t in torch.load(path))
        out.append({
            "leaf_call": locate_call_record(lambda: locate.locate2d_cuda(q, g, b, centre)),
            "weights_call": locate_call_record(
                lambda: locate.locate2d_cuda(q, g, b, centre, affine=affine)),
        })
    print(json.dumps(out))
    return 0


class LocateCalls:
    """The inputs of each locate check, saved for :meth:`profile`, which
    profiles one call of each route on them in a fresh process and adds
    the records to the check's.  Late in this script ``torch.profiler``
    loses device records: it saw no kernel, or only the merge pass, of a
    locate call that the counter and the results show ran, and then none
    of a lone elementwise kernel.  In a fresh process it saw every one."""

    def __init__(self):
        import tempfile

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_locate_")
        self.pending = []

    def save(self, tri, q, rec):
        import os

        import torch

        centre, g_pack, b_pack = tri.locate_tables
        path = os.path.join(self.dir, f"call{len(self.pending)}.pt")
        torch.save([t.cpu() for t in (q, g_pack, b_pack, centre, tri.affine)], path)
        self.pending.append((path, rec))

    def profile(self):
        import os
        import shutil

        here = os.path.dirname(os.path.abspath(__file__))
        paths = [p for p, _ in self.pending]
        out = subprocess.run(
            [sys.executable, "-c",
             f"import sys, chip_smoke; sys.exit(chip_smoke.locate_calls_main({paths!r}))"],
            capture_output=True, text=True, timeout=600, cwd=here,
            env={**os.environ, "PYTHONPATH": here})
        shutil.rmtree(self.dir, ignore_errors=True)
        require(out.returncode == 0, f"the locate call records failed:\n{out.stderr[-3000:]}")
        for (_, rec), calls in zip(self.pending, json.loads(out.stdout.strip().splitlines()[-1])):
            rec.update(calls, kernels_per_call=calls["weights_call"]["kernels_per_call"],
                       slices=calls["weights_call"]["slices"])
            log(f"locate2d calls at B={rec['B']} T={rec['T']}: {json.dumps(calls)}")
            require(calls["leaf_call"]["kernels_per_call"] == rec["kernels_per_call"],
                    f"the two routes launched different kernels: {rec}")
        self.pending = []


LOCATE_CALLS = None  # a LocateCalls while main() runs


def check_locate(tri, q):
    """Kernel against its plain version on the same tables and queries,
    through the two wrappers the main paths call: the leaves
    (``locate_dense_kernel``, the boundary check's route) and the leaves
    and weights (``locate_weights_kernel``, the eval's route), each to the
    bit, the kernel centring the raw queries.  With the times of both
    routes and of their plain versions and the bound; the kernels, slices
    and device ms of one call of each, counted and profiled, join the
    record when ``LOCATE_CALLS.profile()`` runs."""
    from gsl_scattered_interpolation_torch.models import device_tri
    from gsl_scattered_interpolation_torch.ops import locate

    centre, g_pack, b_pack = locate.pack_tables(tri)
    qc = (q - centre).contiguous()
    ref = locate.locate2d_ref(qc, g_pack, b_pack)
    got = locate.locate_dense_kernel(tri, q)
    leaf, w = locate.locate_weights_kernel(tri, q)
    w_ref = device_tri._weights(tri, ref, q)
    diff = (got.long() - ref.long()).abs()
    rec = {"B": int(q.shape[0]), "T": int(tri.n_tris)}
    rec["mismatches"] = int((diff != 0).sum()) + int((leaf != ref).sum())
    rec["max_abs_err"] = float(diff.max())
    rec["weight_mismatches"] = int((w != w_ref).any(dim=1).sum())
    rec["weights_max_abs_err"] = float((w - w_ref).abs().max())
    rec["ms"] = time_ms(lambda: locate.locate_dense_kernel(tri, q), 10)
    rec["device_ms"] = kernel_ms(lambda: locate.locate_dense_kernel(tri, q), 10)
    rec["plain_ms"] = time_ms(lambda: locate.locate2d_ref(
        (q - centre).contiguous(), g_pack, b_pack), 2)
    rec["weights_ms"] = time_ms(lambda: locate.locate_weights_kernel(tri, q), 10)
    rec["weights_device_ms"] = kernel_ms(lambda: locate.locate_weights_kernel(tri, q), 10)
    rec["weights_plain_ms"] = time_ms(lambda: device_tri._weights(
        tri, locate.locate2d_ref((q - centre).contiguous(), g_pack, b_pack), q), 2)
    rec["bound_ms"], rec["bound_by"] = locate_bound_ms(q.shape[0], tri.n_tris)
    rec["weights_bound_ms"], _ = locate_bound_ms(q.shape[0], tri.n_tris, weights=True)
    log(f"locate2d kernel vs plain: {json.dumps(rec)}")
    require(rec["mismatches"] == 0 and rec["weight_mismatches"] == 0,
            f"locate2d disagrees with its plain version: {rec}")
    if LOCATE_CALLS is not None:
        LOCATE_CALLS.save(tri, q, rec)
    return rec


NP_DTYPE = {"float32": np.float32, "float64": np.float64}


def build_points(sites, dtype):
    """The points [N+3, 2] that the build triangulates, as float64 numpy:
    the cage, then the sites jittered by 8 ulps of ``dtype``, each rounded
    to ``dtype``.

    Made here from the raw sites by the reference build's recipe, not by
    the code under test: with ``flags=NOSTANDARDIZE`` the shift is 0 and
    the scale 1; with ``key=None`` there is no shuffle; the jitter is
    ``8 eps * default_rng(12345).uniform(-1, 1, (N, 2))``; the cage is the
    regular triangle of circumradius 1 (linear_simplex.c:215-232) scaled by
    ``1 / (eps^(1/5) * inradius)`` (:234-260).
    """
    np_dtype = NP_DTYPE[str(dtype).split(".")[-1]]
    eps = float(np.finfo(np_dtype).eps)
    chosen = np.sqrt(1.0 - 0.25)
    cage = np.array([[1.0, 0.0], [-0.5, chosen], [-0.5, -(0.5 + 0.25) / chosen]])
    inradius = (cage[0, 0] - cage[1, 0]) / 3
    cage = cage * (1.0 / (eps ** 0.2 * inradius))
    jitter = 8.0 * eps * np.random.default_rng(12345).uniform(-1, 1, sites.shape)
    pts = np.concatenate([cage, sites + jitter])
    return pts.astype(np_dtype).astype(np.float64)


def require_same_points(sites, dtype, pts):
    """The build's own set-up must give the points of :func:`build_points`."""
    import torch

    from gsl_scattered_interpolation_torch.models import device_delaunay as dd
    from gsl_scattered_interpolation_torch.models import host_tree

    *_, shuffle, _, cage_std, sites_std = dd.build_inputs(
        sites, flags=host_tree.NOSTANDARDIZE, dtype=dtype
    )
    theirs = torch.cat([cage_std, torch.as_tensor(sites_std, dtype=dtype)])
    require(np.array_equal(shuffle, np.arange(sites.shape[0])), "key=None shuffled")
    require(np.array_equal(theirs.double().numpy(), pts),
            "the build's points differ from the reference recipe")


def build_states(pts):
    """Drive the build as ``device_delaunay.build_2d`` does and keep
    three states: after 4 rounds of split and 2 flip sub-rounds, right after
    the first split round that leaves fewer than N/2 sites uninserted, and
    the finished triangulation."""
    from gsl_scattered_interpolation_torch.models import device_delaunay as dd

    N = pts.shape[0] - 3
    st = dd._init_state(pts, N)
    states = {}
    rounds = 0
    while int(st.n_left) > 0:
        st = dd._split_round(pts, st)
        if "half" not in states and int(st.n_left) < N / 2:
            states["half"] = st
        st, _ = dd._flip_rounds(pts, st, dd.FLIPS_PER_ROUND)
        rounds += 1
        if rounds == 4:
            states["mid"] = st
    st, _ = dd._flip_rounds(pts, st, dd.MAX_FLIP_ROUNDS, relocate=False)
    states["final"] = st
    return {k: states[k] for k in ("mid", "half", "final")}


def candmath_inputs(pts, st):
    """The exact arguments ``_edge_candidates`` gives the verdict."""
    import torch

    from gsl_scattered_interpolation_torch.models import device_delaunay as dd

    M = st.tri_v.shape[0] - 1
    rows = torch.arange(M, dtype=torch.int32, device=pts.device)
    rvalid = torch.ones(M, dtype=torch.bool, device=pts.device)
    _, _, args = dd._edge_candidate_inputs(
        pts, st.tri_v, st.tri_n, st.cc, rows, rvalid
    )
    apex3, fq3, tv, _, far3, _, valid3, cok, degen_u = args
    kargs = tuple(a.contiguous() for a in (apex3, fq3, tv, far3, valid3, cok, degen_u))
    return args, kargs


def candmath_record(args, kargs, timed: bool, **labels):
    """The candidate kernel against its plain version on one input; with
    ``timed``, the times of both and the kernel's bound."""
    import torch

    from gsl_scattered_interpolation_torch.ops import candmath

    ref = candmath.edge_candidates_math_ref(*args)
    got = candmath.edge_candidates_math_cuda(*kargs)
    torch.cuda.synchronize()
    R = int(ref.shape[0])
    rec = {
        **labels, "dtype": str(args[0].dtype).split(".")[-1], "rows": R,
        "mismatches": int((got != ref).sum()),
        "max_abs_err": float((got != ref).any()),
        "candidates": int(ref.sum()),
    }
    if timed:
        def launch():
            return candmath.edge_candidates_math_cuda(*kargs)

        rec["ms"] = time_ms(launch, 20)
        rec["device_ms"] = kernel_ms(launch)
        rec["plain_ms"] = time_ms(lambda: candmath.edge_candidates_math_ref(*args), 3)
        rec["bound_ms"], rec["bound_by"] = candmath_bound_ms(
            R, args[0].dtype == torch.float64
        )
    log(f"candmath2d kernel vs plain: {json.dumps(rec)}")
    require(rec["mismatches"] == 0, f"candmath2d disagrees with its plain version: {rec}")
    return rec


def check_candmath(sites, dtype, device):
    """Kernel against plain version at the three states; the times at the
    finished state.  Returns a list of records."""
    import torch

    pts = torch.as_tensor(build_points(sites, dtype), dtype=dtype, device=device)
    recs = []
    for label, st in build_states(pts).items():
        args, kargs = candmath_inputs(pts, st)
        rec = candmath_record(args, kargs, label == "final", state=label)
        require(label == "final" or rec["candidates"] > 0, f"no candidates: {rec}")
        recs.append(rec)
    return recs


def check_candmath_compact(sites, device="cuda"):
    """Kernel against plain version on the chunked route's compacted rows:
    the float32 build of ``sites`` from its Qhull seed through one split
    round, then its dirty rows compacted to the big rung's R_COMPACT and
    the tail rung's R_TAIL rows, as its first flip round gathers them.
    Returns the records, timed."""
    import torch

    from gsl_scattered_interpolation_torch.models import device_delaunay as dd
    from gsl_scattered_interpolation_torch.models import host_tree

    *_, cage, std = dd.build_inputs(sites, flags=host_tree.NOSTANDARDIZE, dtype=torch.float32)
    pts, st, dirty = dd._seed_state_2d(std, cage.to(device))
    M = st.tri_v.shape[0] - 1
    R_s = max(min(dd.R_COMPACT // 2, M // 4), 1)
    st, dirty, _ = dd._split_round_compact(pts, st, dirty, R_s, dd.R_SITE)
    n_dirty = int(dirty[:M].sum())
    recs = []
    for R in (dd.R_COMPACT, dd.R_TAIL):
        require(n_dirty >= R, f"{n_dirty} dirty rows fill no {R}-row workspace")
        rows = dd._compact_rows(dirty[:M], R)
        _, _, args = dd._edge_candidate_inputs(
            pts, st.tri_v, st.tri_n, st.cc, rows, rows >= 0
        )
        apex3, fq3, tv, _, far3, _, valid3, cok, degen_u = args
        kargs = tuple(a.contiguous() for a in (apex3, fq3, tv, far3, valid3, cok, degen_u))
        rec = candmath_record(args, kargs, True, state="1M compact")
        require(rec["candidates"] > 0, f"no candidates: {rec}")
        recs.append(rec)
    return recs


# The device activities of a torch.profiler trace, by their "cat".
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(fn):
    """(the device activities of ``fn()`` as trace events, wall ms), from
    ``torch.profiler``.  A kernel's event carries its name, ``dur`` (us)
    and, in ``args``, its ``grid`` and ``block``.  The activities are read
    from the exported trace: ``key_averages`` took 70 s over the 435,000
    launches of a 100,000-site 3D build."""
    import os
    import tempfile

    import torch

    # Device activity only: recording every host op would slow the
    # profiled build many times over.
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    log(f"profiler trace: {len(events)} events read in {time.perf_counter() - t0:.2f} s")
    return [e for e in events if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in DEVICE_CATS], wall_ms


def profile_build(fn):
    """Device time of ``fn()`` by kernel name, from ``torch.profiler``:
    (busy ms, wall ms, {name: (launches, ms)}).  Busy and wall time are of
    the same run, so their ratio is its device idle share; the wall time
    carries the profiler's own cost on the host."""
    events, wall_ms = device_events(fn)
    rows = {}
    for e in events:
        n, ms = rows.get(e["name"], (0, 0.0))
        rows[e["name"]] = (n + 1, ms + float(e["dur"]) / 1e3)
    return sum(ms for _, ms in rows.values()), wall_ms, rows


def _tri_keys(tri, n):
    """int64 key of each triangle's sorted vertex triple."""
    t = np.sort(np.asarray(tri, np.int64), axis=1)
    return (t[:, 0] * n + t[:, 1]) * n + t[:, 2]


def _incircle_exact(a, b, c, d) -> Fraction:
    """The incircle determinant in exact rational arithmetic."""
    F = Fraction
    adx, ady = F(a[0]) - F(d[0]), F(a[1]) - F(d[1])
    bdx, bdy = F(b[0]) - F(d[0]), F(b[1]) - F(d[1])
    cdx, cdy = F(c[0]) - F(d[0]), F(c[1]) - F(d[1])
    ad2, bd2, cd2 = adx * adx + ady * ady, bdx * bdx + bdy * bdy, cdx * cdx + cdy * cdy
    return (adx * (bdy * cd2 - cdy * bd2) - ady * (bdx * cd2 - cdx * bd2)
            + ad2 * (bdx * cdy - cdx * bdy))


def _orient_exact(a, b, c) -> Fraction:
    F = Fraction
    return ((F(b[0]) - F(a[0])) * (F(c[1]) - F(a[1]))
            - (F(b[1]) - F(a[1])) * (F(c[0]) - F(a[0])))


def _on_tie(pts, tri, nbrs, r) -> bool:
    """Whether triangle r shares an exactly cocircular quad with one of its
    neighbours."""
    v = tri[r]
    for u in nbrs[r]:
        far = [x for x in tri[u] if x not in v] if u >= 0 else []
        if far and _incircle_exact(*(pts[i] for i in v), pts[far[0]]) == 0:
            return True
    return False


def _holds_cage(cage, a, b, c) -> bool:
    """Whether a cage vertex lies strictly inside the circumcircle of
    (a, b, c), exactly: then the triangle cannot be in a triangulation
    that includes the cage."""
    o = 1 if _orient_exact(a, b, c) > 0 else -1
    return any(_incircle_exact(a, b, c, v) * o > 0 for v in cage)


def check_triangulation(tri, sites, dtype, rec, scipy_ref=None):
    """The gates of a device build of ``sites``: 2N+1 triangles, structure,
    local Delaunay on the build's own points, and scipy: in float32 at
    least SCIPY_AGREE_MIN of the data triangles are scipy's on the exact
    sites, in float64 every difference from scipy on the build's own
    points is an exact tie or a cage-excluded hull triangle.
    ``scipy_ref`` is that scipy triangulation, or None to make it here
    (then its seconds are recorded).  Fills ``rec``; returns scipy's
    triangulation of the build's own points in float64, else None."""
    import torch
    from scipy.spatial import Delaunay

    from gsl_scattered_interpolation_torch.utils import integrity

    N = sites.shape[0]
    pts = build_points(sites, dtype)
    require(tri.n_tris == 2 * N + 1, f"{tri.n_tris} triangles, not {2 * N + 1}")
    tv = tri.tri_verts.cpu().numpy()
    tn = tri.tri_nbrs.cpu().numpy()
    integrity.check_array_structure(tv, tn)
    # Local Delaunay on the build's own coordinates, in float64.
    rec["local_delaunay_violations"] = integrity.local_delaunay_violations(pts, tv, tn)
    require(rec["local_delaunay_violations"] == 0, f"local Delaunay fails: {rec}")

    data = (tv > 2).all(axis=1)
    ours = _tri_keys(tv[data] - 3, N)
    sd = scipy_ref
    if sd is None:
        t0 = time.perf_counter()
        sd = Delaunay(sites if dtype == torch.float32 else pts[3:])
        rec["scipy_delaunay_s"] = time.perf_counter() - t0
    if dtype == torch.float32:
        theirs = _tri_keys(sd.simplices, N)
        rec["scipy_agree"] = float(np.isin(ours, theirs).mean())
        require(rec["scipy_agree"] >= SCIPY_AGREE_MIN, f"scipy agreement: {rec}")
        return None
    # scipy on the build's own standardized, jittered float64 sites.
    site_pts = pts[3:]
    theirs = _tri_keys(sd.simplices, N)
    only_ours = np.nonzero(data)[0][~np.isin(ours, theirs)]
    only_theirs = np.nonzero(~np.isin(theirs, ours))[0]
    # A difference is explained by an exact tie, or, for one of scipy's
    # hull triangles, by a cage vertex inside its circumcircle.
    ties = sum(_on_tie(pts, tv, tn, r) for r in only_ours)
    ties_theirs = [_on_tie(site_pts, sd.simplices, sd.neighbors, r)
                   for r in only_theirs]
    caged = sum(
        not tie and _holds_cage(pts[:3], *site_pts[sd.simplices[r]])
        for r, tie in zip(only_theirs, ties_theirs)
    )
    ties += sum(ties_theirs)
    rec.update(scipy_data_tris=int(theirs.size),
               scipy_only_ours=int(only_ours.size),
               scipy_only_theirs=int(only_theirs.size),
               scipy_ties=ties, scipy_cage_excluded=caged)
    require(ties + caged == only_ours.size + only_theirs.size,
            f"f64 build differs from scipy beyond exact ties: {rec}")
    return sd


def build_at_scale(sites, dtype, device):
    """``triangulate`` of the sites on the card, with its checks.  Returns
    a record of what was measured, and scipy's triangulation of the
    build's own points in float64 (None in float32, where the check uses
    the exact sites)."""
    import torch

    from gsl_scattered_interpolation_torch.models import device_delaunay as dd
    from gsl_scattered_interpolation_torch.models import host_tree
    from gsl_scattered_interpolation_torch.ops import candmath

    N = sites.shape[0]
    require_same_points(sites, dtype, build_points(sites, dtype))

    def run(stats=None):
        return dd.triangulate(
            sites, flags=host_tree.NOSTANDARDIZE, dtype=dtype, device=device,
            stats=stats,
        )

    stats = {}
    candmath.edge_candidates_math_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tri, _ = run(stats)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = candmath.edge_candidates_math_cuda.launches
    sub_rounds = stats["insert_sub_rounds"] + stats["cleanup_sub_rounds"]
    rec = {"dtype": str(dtype).split(".")[-1], "n_sites": N,
           "n_tris": tri.n_tris, "build_s": build_s, **stats,
           "candmath_launches": launches}
    require(launches == sub_rounds, f"{launches} launches for {sub_rounds} sub-rounds")
    if dtype == torch.float32:
        # The same build again under the profiler, for the device time by
        # kernel and the idle share of that run; its host clock carries
        # the profiler's cost, so build_s is taken from the run above.
        # (The float64 build is not profiled: the 1M phase needed the
        # time.)
        busy_ms, wall_ms, rows = profile_build(run)
        kernel = [v for k, v in rows.items() if candmath.KERNEL in k]
        require(len(kernel) == 1, f"the profiler saw {len(kernel)} {candmath.KERNEL} rows")
        kernel_launches, kernel_ms = kernel[0]
        require(kernel_launches == launches,
                f"the profiler saw {kernel_launches} launches, the counter {launches}")
        top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:6]
        rec.update(candmath_ms_total=kernel_ms,
                   candmath_share_of_build=kernel_ms / wall_ms,
                   device_busy_ms=busy_ms,
                   device_idle_share=1.0 - busy_ms / wall_ms,
                   top_kernels_ms={k[:80]: ms for k, (_, ms) in top},
                   profiled_build_s=wall_ms / 1e3)
    t0 = time.perf_counter()
    sd = check_triangulation(tri, sites, dtype, rec)
    rec["checks_s"] = time.perf_counter() - t0
    log(f"device build at scale: {json.dumps(rec)}")
    return rec, sd


def sync(device) -> None:
    """Wait for the card, if ``device`` is one."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main_path(device, n_sites: int, batch: int, n_batches: int, n_check: int,
              engine: str):
    """Build the facade with ``engine`` and evaluate ``n_batches`` query
    batches.  Returns a dict of what was measured and checked; raises on a
    failed check."""
    import torch

    from gsl_scattered_interpolation_torch import ScatteredInterp
    from gsl_scattered_interpolation_torch.models import device_tri
    from gsl_scattered_interpolation_torch.models.scattered import NOSTANDARDIZE
    from scipy.interpolate import LinearNDInterpolator

    sites, values = headline_problem(n_sites, seed=0)
    t0 = time.perf_counter()
    si = ScatteredInterp(
        sites, values, flags=NOSTANDARDIZE, engine=engine, device=device
    )
    sync(device)
    build_s = time.perf_counter() - t0
    Q = uniform_queries(batch, seed=1, device=device, batches=n_batches)

    sync(device)
    t0 = time.perf_counter()
    outs = [si.eval(Q[i]) for i in range(n_batches)]
    sync(device)
    eval_s = time.perf_counter() - t0

    out0 = outs[0][:n_check]
    require(
        out0.shape == (n_check,) and bool(torch.isfinite(out0).all()),
        f"eval gave {tuple(out0.shape)} or non-finite values",
    )
    q0 = Q[0, :n_check]
    dense = device_tri.interp(si.tri, si.response, q0, method="dense")
    vs_dense = float((out0 - dense).abs().max())
    qn = q0.double().cpu().numpy()
    got = out0.double().cpu().numpy()
    ref = LinearNDInterpolator(sites, values)(qn)
    inside = np.isfinite(ref)
    vs_scipy = float(np.abs(got[inside] - ref[inside]).max())
    res = {
        "engine": engine,
        "n_simplexes": si.n_simplexes,
        "build_s": build_s,
        "eval_s": eval_s,
        "queries_per_s": batch * n_batches / eval_s,
        "eval_vs_dense_max": vs_dense,
        "eval_vs_scipy_max": vs_scipy,
    }
    if engine == "device":
        # The device build triangulates the sites as it sees them: rounded
        # to the build dtype and jittered by 8 of its ulps.  In float32 that
        # moves near-cocircular quads, so scipy's reference is built on
        # those same coordinates (in raw units); the gap to scipy on the
        # exact sites is reported beside it.
        res["eval_vs_scipy_exact_sites_max"] = vs_scipy
        require(np.array_equal(si.shuffle, np.arange(n_sites)), "key=None shuffled")
        own = build_points(sites, si.tri.dtype)[3:]
        ref = LinearNDInterpolator(own, values)(qn)
        inside = np.isfinite(ref)
        vs_scipy = res["eval_vs_scipy_max"] = float(
            np.abs(got[inside] - ref[inside]).max()
        )
    require(inside.sum() > 0.99 * n_check, f"{inside.sum()} queries in the hull")
    require(vs_dense < EVAL_VS_DENSE_MAX, f"eval vs dense locate {vs_dense}")
    require(vs_scipy < EVAL_VS_SCIPY_MAX, f"eval vs scipy {vs_scipy}")
    return res


def at_scale_query(sites, dtype, n_batches: int, scipy_tri=None, device="cuda",
                   grid_res: int = 256):
    """The at-scale query path on the card: ``ScatteredInterp`` with
    ``engine="device"`` of ``sites`` (the headline's test function), its
    cell index, and ``n_batches`` eval batches of a million queries, each
    counted from zero.  Gated on the first N_CHECK queries: against the
    locate kernel forced at this T (float32) and against scipy on the
    build's own points (``scipy_tri``, or a new Delaunay of them).
    Returns (record, facade)."""
    import torch
    from scipy.interpolate import LinearNDInterpolator
    from scipy.spatial import Delaunay

    from gsl_scattered_interpolation_torch import ScatteredInterp
    from gsl_scattered_interpolation_torch.models import device_tri
    from gsl_scattered_interpolation_torch.models.scattered import NOSTANDARDIZE
    from gsl_scattered_interpolation_torch.ops import candmath, locate
    from gsl_scattered_interpolation_torch.ops import cells as cells_ops
    from gsl_scattered_interpolation_torch.ops import walk as walk_ops

    values = headline_values(sites)
    f32 = dtype == torch.float32
    locate.locate2d_cuda.launches = 0
    candmath.edge_candidates_math_cuda.launches = 0
    cells_ops.cells2d_cuda.launches = 0
    walk_ops.walk2d_cuda.launches = 0
    sync(device)
    t0 = time.perf_counter()
    si = ScatteredInterp(sites, values, flags=NOSTANDARDIZE, engine="device",
                         dtype=dtype, grid_res=grid_res, device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    T = si.n_simplexes
    t0 = time.perf_counter()
    cells = si._get_cells()
    sync(device)
    index_s = time.perf_counter() - t0
    Q = uniform_queries(BATCH, seed=5, device=device, batches=n_batches).to(dtype)

    walked = []
    steps = device_tri.locate.steps
    sync(device)
    t0 = time.perf_counter()
    outs = []
    for i in range(n_batches):
        before = device_tri.locate.queries
        outs.append(si.eval(Q[i]))
        walked.append(device_tri.locate.queries - before)
    sync(device)
    eval_s = time.perf_counter() - t0
    rec = {
        "dtype": str(dtype).split(".")[-1], "n_sites": sites.shape[0],
        "n_simplexes": T, "build_s": build_s,
        "index_method": device_tri.auto_index_method(si.tri.device.type, T),
        "index_s": index_s, "G": cells.res, "K": cells.k,
        "table_MB": cells.table.numel() * 4 / 1e6, "complete": cells.complete,
        "overflow_cells": int(cells.overflow.sum()),
        "eval_s": eval_s, "queries_per_s": BATCH * n_batches / eval_s,
        "walked_per_batch": walked,
        "walk_steps": device_tri.locate.steps - steps,
        "locate2d_launches": locate.locate2d_cuda.launches,
        "candmath2d_launches": candmath.edge_candidates_math_cuda.launches,
        "cells2d_launches": cells_ops.cells2d_cuda.launches,
        "walk2d_launches": walk_ops.walk2d_cuda.launches,
    }
    require(T == 2 * sites.shape[0] + 1, f"{T} simplexes")
    on_card = f32 and si.tri.device.type == "cuda"  # the kernels' route
    require(rec["cells2d_launches"] == (n_batches if on_card else 0),
            f"{rec['cells2d_launches']} cells2d launches for {n_batches} {rec['dtype']} batches")
    walking = sum(1 for m in walked if m)
    require(rec["walk2d_launches"] == (walking if on_card else 0),
            f"{rec['walk2d_launches']} walk2d launches for {walking} {rec['dtype']} batches that walk")
    require(rec["candmath2d_launches"] > 0, "the build never launched candmath2d")

    out0 = outs[0][:N_CHECK]
    require(out0.shape == (N_CHECK,) and bool(torch.isfinite(out0).all()),
            f"eval gave {tuple(out0.shape)} or non-finite values")
    q0 = Q[0, :N_CHECK]
    if f32:
        # The brute-force kernel at this T as the cross-check (bench.py's
        # boundary check): leaves and values.
        leaf, _, _ = device_tri.locate_cells(si.tri, cells, q0)
        kleaf = locate.locate_dense_kernel(si.tri, q0)
        kval = device_tri.interp(si.tri, si.response, q0, method="pallas")
        rec["leaf_mismatch_vs_locate2d"] = float((leaf != kleaf.long()).float().mean())
        rec["eval_vs_locate2d_max"] = float((out0 - kval).abs().max())
        require(rec["leaf_mismatch_vs_locate2d"] < LEAF_MISMATCH_MAX, f"leaves: {rec}")
        require(rec["eval_vs_locate2d_max"] < EVAL_VS_DENSE_MAX, f"values vs locate2d: {rec}")
    if scipy_tri is None:
        scipy_tri = Delaunay(build_points(sites, dtype)[3:])
    ref = LinearNDInterpolator(scipy_tri, values)(q0.double().cpu().numpy())
    inside = np.isfinite(ref)
    got = out0.double().cpu().numpy()
    rec["eval_vs_scipy_max"] = float(np.abs(got[inside] - ref[inside]).max())
    limit = EVAL_VS_SCIPY_MAX if f32 else EVAL_VS_SCIPY_F64_MAX
    require(inside.sum() > 0.99 * N_CHECK, f"{inside.sum()} queries in the hull")
    require(rec["eval_vs_scipy_max"] < limit, f"eval vs scipy: {rec}")
    log(f"at-scale query: {json.dumps(rec)}")
    return rec, si


def crossover(cases, device="cuda"):
    """Milliseconds per million f32 queries of ``interp`` through the
    locate kernel, the cell index and the walk, and seconds of the cell
    index's host and device builds (after one untimed device build), for
    each (triangulation, response, cell index or None to build one)
    case."""
    from gsl_scattered_interpolation_torch.models import device_tri

    q = uniform_queries(BATCH, seed=6, device=device)[0]
    out = []
    for tri, resp, cells in cases:
        rec = {"T": tri.n_tris, "B": int(q.shape[0])}
        device_tri.build_cell_index(tri, method="device")
        for method in ("host", "device"):
            sync(device)
            t0 = time.perf_counter()
            built = device_tri.build_cell_index(tri, method=method)
            sync(device)
            rec[f"index_{method}_s"] = time.perf_counter() - t0
        if cells is None:
            cells = built
        for method in ("pallas", "cells", "walk"):
            reps = 2 if method == "pallas" and tri.n_tris > 100_000 else 5
            rec[f"{method}_ms"] = time_ms(
                lambda: device_tri.interp(tri, resp, q, method=method, cells=cells), reps
            )
        log(f"crossover, ms per batch: {json.dumps(rec)}")
        out.append(rec)
    sync(device)
    return out


BUILD_COUNTS = ("seeded", "insert_iterations", "split_rounds", "insert_sweep_rounds",
                "final_sweep_rounds", "flips", "candidate_edges", "cleanup_sub_rounds")
BUILD_PHASES = ("setup_s", "seed_s", "insert_s", "sweep_s")


def build_1m(sites, dtype, n_batches: int, scipy_own, scipy_exact=None,
             device="cuda"):
    """bench.py's build at 1M through ``ScatteredInterp(engine="device")``
    (``at_scale_query`` with grid_res 512, counted from zero), with the
    build's host seconds by phase and its counts, and the gates of
    :func:`check_triangulation` (``scipy_own``: scipy's triangulation of
    the build's own points; ``scipy_exact``: of the exact sites, for the
    float32 agreement).  The float32 build must have been seeded from
    Qhull.  (A float64 seed whose walk leaves sites unlocated falls back
    to the unseeded build, as the JAX package does; the record says which
    ran.)  Returns the record."""
    import torch

    require_same_points(sites, dtype, build_points(sites, dtype))
    torch.cuda.reset_peak_memory_stats()
    rec, si = at_scale_query(sites, dtype, n_batches, scipy_tri=scipy_own,
                             device=device, grid_res=GRID_RES_1M)
    stats = si.build_stats  # triangulate's stats
    rec["peak_memory_GB"] = torch.cuda.max_memory_allocated() / 1e9
    rec.update({k: stats[k] for k in BUILD_PHASES})
    rec["freeze_s"] = rec["build_s"] - sum(stats[k] for k in BUILD_PHASES)
    rec.update({k: stats[k] for k in BUILD_COUNTS})
    f32 = dtype == torch.float32
    require(stats["seeded"] is True or not f32, f"the 1M build was not seeded: {rec}")
    sweeps = (stats["insert_sweep_rounds"] + stats["final_sweep_rounds"]
              + stats["cleanup_sub_rounds"])
    require(rec["candmath2d_launches"] == sweeps,
            f"{rec['candmath2d_launches']} candmath2d launches for {sweeps} flip rounds")
    t0 = time.perf_counter()
    check_triangulation(si.tri, sites, dtype, rec,
                        scipy_ref=scipy_exact if f32 else scipy_own)
    rec["checks_s"] = time.perf_counter() - t0
    if f32:
        rec["cells2d"] = cells2d_record(si)
        pool = uniform_queries(CELLS_BATCH, seed=CELLS_SEED, device="cuda",
                               batches=WALK_BATCHES)
        rec["walk2d"] = walk2d_record(si, pool)
        del pool
    log(f"build at 1M: {json.dumps(rec)}")
    return rec


def phase_1m(device="cuda"):
    """The build at 1M: scipy's Delaunay of the sites, timed alone; the
    candidate kernel on the compacted rows; the float32 build without a
    seed (host seconds); scipy's triangulations of the build's own points
    in float32 and float64, in two threads with nothing else running; the
    seeded float32 build alone under ``torch.profiler`` (device time and
    the idle share of that run); then :func:`build_1m` in float32 and
    float64.  Returns (candidate kernel records, {"f32": record, "f64":
    record})."""
    import torch
    from scipy.spatial import Delaunay

    from gsl_scattered_interpolation_torch.models import device_delaunay as dd
    from gsl_scattered_interpolation_torch.models import host_tree
    from gsl_scattered_interpolation_torch.ops import candmath

    sites = np.random.default_rng(SEED_1M).uniform(-0.5, 0.5, size=(N_1M, 2))
    t0 = time.perf_counter()
    scipy_exact = Delaunay(sites)
    scipy_s = time.perf_counter() - t0
    compact = check_candmath_compact(sites, device)

    def build(**kw):
        return dd.triangulate(sites, flags=host_tree.NOSTANDARDIZE, dtype=torch.float32,
                              grid_res=GRID_RES_1M, device=device, **kw)

    unseeded = {}
    sync(device)
    t0 = time.perf_counter()
    build(seed_import="self", stats=unseeded)
    sync(device)
    unseeded_s = time.perf_counter() - t0
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        own = {dt: pool.submit(lambda d=dt: Delaunay(build_points(sites, d)[3:]))
               for dt in (torch.float32, torch.float64)}
        scipy_own = {dt: f.result() for dt, f in own.items()}
    profiled = {}
    busy_ms, wall_ms, rows = profile_build(lambda: build(stats=profiled))
    require(profiled["seeded"] is True, "the profiled 1M build was not seeded")
    b1m = {"f32": build_1m(sites, torch.float32, N_BATCHES, scipy_own[torch.float32],
                           scipy_exact, device),
           "f64": build_1m(sites, torch.float64, 1, scipy_own[torch.float64],
                           device=device)}
    kernel = [v for k, v in rows.items() if candmath.KERNEL in k]
    require(len(kernel) == 1, f"the profiler saw {len(kernel)} {candmath.KERNEL} rows")
    rec = b1m["f32"]
    require(kernel[0][0] == rec["candmath2d_launches"],
            f"the profiler saw {kernel[0][0]} launches, the counter "
            f"{rec['candmath2d_launches']}")
    top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:8]
    extra = {"scipy_delaunay_s": scipy_s, "device_busy_ms": busy_ms,
             "profiled_triangulate_s": wall_ms / 1e3,
             "device_idle_share": 1.0 - busy_ms / wall_ms,
             "candmath_ms_total": kernel[0][1],
             "top_kernels_ms": {k[:80]: ms for k, (_, ms) in top},
             "unseeded_triangulate_s": unseeded_s,
             "unseeded": {k: unseeded[k] for k in (*BUILD_PHASES, *BUILD_COUNTS)}}
    rec.update(extra)
    log(f"build at 1M, f32 device time and unseeded build: {json.dumps(extra)}")
    return compact, b1m


def values_3d(sites):
    """bench.py's 3D test function at ``sites``."""
    return np.sin(3 * sites[:, 0]) * np.cos(2 * sites[:, 1]) + sites[:, 2]


def cavity_facade(sites, dtype, device, salt: float = 0.0):
    """``ScatteredInterp(engine="cavity")`` of ``sites + salt`` with
    bench.py's 3D values, both kernel counters set to 0 just before.
    Returns (facade, record of the build's seconds, stats and launches)."""
    import torch

    from gsl_scattered_interpolation_torch import ScatteredInterp
    from gsl_scattered_interpolation_torch.models.scattered import NOSTANDARDIZE
    from gsl_scattered_interpolation_torch.ops import candmath, locate

    locate.locate2d_cuda.launches = 0
    candmath.edge_candidates_math_cuda.launches = 0
    sync(device)
    t0 = time.perf_counter()
    si = ScatteredInterp(sites + salt, values_3d(sites), flags=NOSTANDARDIZE,
                         engine="cavity", dtype=dtype, device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    stats = si.build_stats  # triangulate's stats
    w = stats["winners"]
    rec = {"dtype": str(dtype).split(".")[-1], "n_sites": sites.shape[0],
           "n_tets": si.n_simplexes, "build_s": build_s,
           **{k: stats[k] for k in ("setup_s", "seed_s", "rounds_s", "freeze_s",
                                    "seeded", "seed_sites", "seed_left_out", "rounds",
                                    "escalations",
                                    "cavity_cap")},
           "winners_min_mean_max": [min(w, default=0), sum(w) / max(len(w), 1),
                                    max(w, default=0)],
           "winners_per_round": w,
           "locate2d_launches": locate.locate2d_cuda.launches,
           "candmath2d_launches": candmath.edge_candidates_math_cuda.launches}
    require(si.engine == "cavity" and si.tri.dim == 3, "not a 3D cavity build")
    require(sum(w) == sites.shape[0] - stats["seed_sites"], f"winners: {rec}")
    return si, rec


def check_3d(si, scipy_tri, values, q, limit, rec, prefix=""):
    """The 3D gates: neighbour structure of the tetrahedra, every query
    located, and ``si.eval(q)`` within ``limit`` of scipy's linear
    interpolant on ``scipy_tri`` (the build's own points).  Fills ``rec``
    with the error's p999 and max."""
    import torch
    from scipy.interpolate import LinearNDInterpolator

    from gsl_scattered_interpolation_torch.utils import integrity

    integrity.check_array_structure(si.tri.tri_verts.cpu().numpy(),
                                    si.tri.tri_nbrs.cpu().numpy())
    qt = si._queries(q)
    out = si.eval(qt)
    _, _, ok = si._locate(qt)
    require(out.shape == (q.shape[0],) and bool(torch.isfinite(out).all()),
            f"eval gave {tuple(out.shape)} or non-finite values")
    ref = LinearNDInterpolator(scipy_tri, values)(q)
    inside = np.isfinite(ref)
    err = np.abs(out.double().cpu().numpy()[inside] - ref[inside])
    rec.update({f"{prefix}located": bool(ok.all()),
                f"{prefix}in_scipy_hull": float(inside.mean()),
                f"{prefix}eval_vs_scipy_p999": float(np.quantile(err, 0.999)),
                f"{prefix}eval_vs_scipy_max": float(err.max())})
    require(rec[f"{prefix}located"], f"a query was not located: {rec}")
    require(inside.mean() > 0.99, f"{inside.mean()} of the queries in scipy's hull")
    require(err.max() < limit, f"eval vs scipy: {rec}")


def own_points_3d(sites, dtype):
    """The coordinates a cavity build of ``sites`` triangulates (flags
    NOSTANDARDIZE): rounded to float32 (no jitter), or the float64 sites
    (a jitter of 2^16 ulps, far below the tolerance)."""
    import torch

    if dtype == torch.float32:
        return sites.astype(np.float32).astype(np.float64)
    return sites


def queries_3d(si, sites, device="cuda"):
    """bench.py's queries_3d over the float32 10k build: its 3D cell index
    built on the card (timed, with its layout and dropped share), then 10
    batches of Q3D_BATCH queries through ``eval``, counted from zero.
    Gated against the walk on the first batch (leaves and values) and
    against scipy on N_3D_CHECK of its queries.  Returns the record."""
    import torch
    from scipy.spatial import Delaunay

    from gsl_scattered_interpolation_torch.models import device_tri
    from gsl_scattered_interpolation_torch.ops import candmath, locate

    locate.locate2d_cuda.launches = 0
    candmath.edge_candidates_math_cuda.launches = 0
    sync(device)
    t0 = time.perf_counter()
    cells = device_tri.build_cell_index(si.tri)
    sync(device)
    index_s = time.perf_counter() - t0
    si._cells = cells
    gen = torch.Generator(device=device).manual_seed(Q3D_SEED)
    Q = torch.rand(N_BATCHES, Q3D_BATCH, 3, generator=gen, device=device) * 0.9 - 0.45
    walked = []
    sync(device)
    t0 = time.perf_counter()
    outs = []
    for i in range(N_BATCHES):
        before = device_tri.locate.queries
        outs.append(si.eval(Q[i]))
        walked.append(device_tri.locate.queries - before)
    sync(device)
    eval_s = time.perf_counter() - t0
    rec = {"n_tets": si.n_simplexes, "index_s": index_s,
           "index_method": device_tri.auto_index_method(device, si.n_simplexes, 3),
           "G": cells.res, "K": cells.k,
           "layout": "packed" if cells.rows is None else "two-stage",
           "table_MB": cells.table.numel() * 4 / 1e6, "complete": cells.complete,
           "n_bad": cells.n_bad, "n_pairs": cells.n_pairs,
           "dropped_share": cells.n_bad / max(cells.n_pairs, 1),
           "overflow_cells": int(cells.overflow.sum()),
           "eval_s": eval_s, "queries_per_s": Q3D_BATCH * N_BATCHES / eval_s,
           "walked_per_batch": walked,
           "locate2d_launches": locate.locate2d_cuda.launches,
           "candmath2d_launches": candmath.edge_candidates_math_cuda.launches}
    q0 = Q[0]
    leaf, w, ok = device_tri.locate_cells(si.tri, cells, q0)
    wleaf, ww, wok = device_tri.locate(si.tri, q0)
    walk = device_tri.interp(si.tri, si.response, q0, method="walk")
    rec["leaf_mismatch_vs_walk"] = float((leaf != wleaf).float().mean())
    rec["eval_vs_walk_max"] = float((outs[0] - walk).abs().max())
    require(rec["leaf_mismatch_vs_walk"] < LEAF_MISMATCH_MAX, f"leaves vs walk: {rec}")
    require(rec["eval_vs_walk_max"] < EVAL_VS_DENSE_MAX, f"values vs walk: {rec}")
    q = Q[0, :N_3D_CHECK].double().cpu().numpy()
    check_3d(si, Delaunay(own_points_3d(sites, torch.float32)), values_3d(sites), q,
             EVAL_VS_SCIPY_MAX, rec)
    log(f"queries_3d: {json.dumps(rec)}")
    return rec


def phase_3d(device="cuda"):
    """The 3D phase, at bench.py's sizes.  cavity3d_10k: the float32 facade
    of 10,000 sites (first build, then one rebuild of salted sites), its
    gates against scipy and scipy's Delaunay seconds; the same in float64
    within 1e-9.  queries_3d over the float32 build (:func:`queries_3d`).
    cavity3d_100k: the float32 facade of 100,000 sites (build seconds by
    phase, peak memory, gates), scipy's seconds and the device idle share
    of a profiled build.  Returns {name: record}."""
    import torch
    from scipy.spatial import Delaunay

    from gsl_scattered_interpolation_torch.models import device_cavity as dc
    from gsl_scattered_interpolation_torch.models import host_tree

    out = {}
    t_lap = [time.perf_counter()]

    def lap(label):
        now = time.perf_counter()
        log(f"phase 3D, {label}: {now - t_lap[0]:.2f} s")
        t_lap[0] = now

    rng = np.random.default_rng(SEED_3D)
    sites = rng.uniform(-0.5, 0.5, size=(N_3D, 3))
    q = rng.uniform(-0.45, 0.45, size=(N_3D_CHECK, 3))
    t0 = time.perf_counter()
    Delaunay(sites)
    scipy_s = time.perf_counter() - t0
    si, rec = cavity_facade(sites, torch.float32, device)
    _, again = cavity_facade(sites, torch.float32, device, salt=1e-7)
    rec.update(scipy_delaunay_s=scipy_s, rebuild_salted_s=again["build_s"],
               rebuild_rounds=again["rounds"])
    own = Delaunay(own_points_3d(sites, torch.float32))
    theirs = {tuple(r) for r in np.sort(own.simplices, 1).tolist()}
    tv = si.tri.tri_verts.cpu().numpy()
    data = np.sort(tv[(tv > 3).all(1)] - 4, 1)  # user ids: key=None
    rec["scipy_agree"] = float(np.mean([tuple(r) in theirs for r in data.tolist()]))
    check_3d(si, own, values_3d(sites), q, EVAL_VS_SCIPY_MAX, rec)
    out["cavity3d_10k"] = rec
    log(f"cavity3d_10k f32: {json.dumps(rec)}")
    lap("10k float32")
    si64, rec64 = cavity_facade(sites, torch.float64, device)
    check_3d(si64, Delaunay(sites), values_3d(sites), q, EVAL_VS_SCIPY_F64_MAX, rec64)
    out["cavity3d_10k_f64"] = rec64
    log(f"cavity3d_10k f64: {json.dumps(rec64)}")
    del si64
    lap("10k float64")
    out["queries_3d"] = queries_3d(si, sites, device)
    del si
    lap("queries_3d")

    rng = np.random.default_rng(SEED_3D_LARGE)
    big = rng.uniform(-0.5, 0.5, size=(N_3D_LARGE, 3))
    q = rng.uniform(-0.45, 0.45, size=(N_3D_CHECK, 3))
    t0 = time.perf_counter()
    Delaunay(big)
    scipy_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    si, rec = cavity_facade(big, torch.float32, device)
    check_3d(si, Delaunay(own_points_3d(big, torch.float32)), values_3d(big), q,
             EVAL_VS_SCIPY_MAX, rec)
    rec["peak_memory_GB"] = torch.cuda.max_memory_allocated() / 1e9
    rec["index"] = {"G": si._cells.res, "K": si._cells.k, "complete": si._cells.complete,
                    "layout": "packed" if si._cells.rows is None else "two-stage",
                    "dropped_share": si._cells.n_bad / max(si._cells.n_pairs, 1)}
    del si
    lap("100k build and gates")
    busy_ms, wall_ms, rows = profile_build(lambda: dc.triangulate(
        big, flags=host_tree.NOSTANDARDIZE, dtype=torch.float32, device=device))
    lap("100k profiled build")
    top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:8]
    rec.update(scipy_delaunay_s=scipy_s, device_busy_ms=busy_ms,
               profiled_triangulate_s=wall_ms / 1e3,
               device_idle_share=1.0 - busy_ms / wall_ms,
               device_launches=sum(n for n, _ in rows.values()),
               top_kernels_ms={k[:80]: ms for k, (_, ms) in top})
    out["cavity3d_100k"] = rec
    log(f"cavity3d_100k: {json.dumps(rec)}")
    return out


# The RBF phase, at bench.py's sizes and seeds (bench_tps, bench_wendland,
# bench_weights, bench_kriging), and the direct solver's limit.
N_TPS = 100_000
N_TPS_CHECK = 20_000
N_WENDLAND = 1_000_000
N_WENDLAND_CHECK = 10_000
N_WEIGHTS = 4096
N_KRIGING = 100_000
KRIGING_QUERIES = 1_000_000
KRIGING_CHUNK = 262_144
N_KRIGING_CHECK = 20_000
N_DIRECT = 8192            # the largest RbfInterp(solver="auto") solves directly
N_DIRECT_CHECK = 20_000
N_PCG_LARGE = 50_000
# Two GMRES(60) restarts at 50,000 sites.  The default cg_maxiter of 500
# (8 restarts, 496 matvecs) took 63 s on the card and ended at a relative
# residual of 2.3e-2: the preconditioner stalls at this size.
PCG_LARGE_MAXITER = 120
TPS_SITE_RESID_MAX = 1e-4
TPS_SITE_RESID_F64_MAX = 1e-8  # test_weight_accuracy.py:184
WENDLAND_SITE_RESID_MAX = 1e-3
WEIGHTS_REFINED_MAX = 1e-6
WEIGHTS_F64_MAX = 1e-8
KRIGING_RMSE_MAX = 0.05
KRIGING_F32_VS_F64_MAX = 1e-3
DIRECT_SITE_RESID_F64_MAX = 1e-8
PCG_VS_DIRECT_MAX = 1e-6


def _timed(fn, device):
    """(fn(), seconds), the card synchronised before and after."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def _counted():
    """{kernel: its wrapper}, each wrapper carrying its launch count (looked
    up now: a Recorder may stand in for the tridiagonal wrappers)."""
    from gsl_scattered_interpolation_torch.ops import candmath, cells, locate, tridiag, walk

    return {"locate2d": locate.locate2d_cuda,
            "candmath2d": candmath.edge_candidates_math_cuda,
            "cells2d": cells.cells2d_cuda,
            "walk2d": walk.walk2d_cuda,
            "tridiag": tridiag.thomas_cuda,
            "tridiag_partitioned": tridiag.partitioned_cuda}


def _zero_counts(wrappers):
    """Set each wrapper's count of calls, and of CUDA kernels where it
    keeps one (``kernel_launches``), to 0."""
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "kernel_launches"):
            w.kernel_launches = 0


def _kernel_counts(wrappers):
    return {k: w.kernel_launches for k, w in wrappers.items() if hasattr(w, "kernel_launches")}


def _main_run(rec, fn):
    """``fn()`` as a run of the configuration's main path: every kernel
    counter set to 0 just before and read just after, the wrapper calls
    added to ``rec["main_launches"]`` and the CUDA kernels of the wrappers
    that count them to ``rec["main_kernels"]``.  The checks and timings
    around it launch kernels too; those launches are not counted."""
    wrappers = _counted()
    _zero_counts(wrappers)
    out = fn()
    main = rec.setdefault("main_launches", dict.fromkeys(wrappers, 0))
    kernels = rec.setdefault("main_kernels", dict.fromkeys(_kernel_counts(wrappers), 0))
    for k, w in wrappers.items():
        main[k] += w.launches
    for k, n in _kernel_counts(wrappers).items():
        kernels[k] += n
    return out


def _config(name, device, body):
    """Run ``body(rec)`` for one configuration with every kernel counter
    and the peak-memory counter set to 0 just before; the record gets the
    peak memory, the seconds, the launches (wrapper calls) and the CUDA
    kernels of the wrappers that count them: those of the runs the body
    marks with :func:`_main_run`, or of the whole body where it marks none
    (the RBF phase, on which no kernel runs)."""
    import torch

    _zero_counts(_counted())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec = {}
    body(rec)
    main = rec.pop("main_launches", None) or {k: w.launches for k, w in _counted().items()}
    kernels = rec.pop("main_kernels", None) or _kernel_counts(_counted())
    rec.update(phase_s=time.perf_counter() - t0,
               peak_memory_GB=torch.cuda.max_memory_allocated() / 1e9,
               **{f"{k}_launches": n for k, n in main.items()},
               **{f"{k}_kernels": n for k, n in kernels.items()})
    log(f"{name}: {json.dumps(rec)}")
    return rec


def _profiled(rec, label, fn):
    """Device busy ms over the wall ms of ``fn()`` (torch.profiler) into
    ``rec`` under ``label``."""
    busy_ms, wall_ms, rows = profile_build(fn)
    top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:5]
    rec[label] = {"wall_s": wall_ms / 1e3, "device_busy_ms": busy_ms,
                  "device_idle_share": 1.0 - busy_ms / wall_ms,
                  "device_launches": sum(n for n, _ in rows.values()),
                  "top_kernels_ms": {k[:80]: ms for k, (_, ms) in top}}


def tps_100k(rec, device="cuda"):
    """bench.py's tps_100k: rbf_pu.fit of 100,000 sites in float32, its
    site residual over 20,000 of them; the same fit in float64, and the
    float32 - float64 difference at 20,000 off-site queries."""
    import torch

    from gsl_scattered_interpolation_torch.models import rbf_pu

    rng = np.random.default_rng(3)
    sites = rng.uniform(-1.0, 1.0, size=(N_TPS, 2))
    values = np.sin(3 * sites[:, 0]) * np.cos(2 * sites[:, 1]) + sites[:, 1]
    stats = {}
    m32, rec["fit_s"] = _timed(lambda: rbf_pu.fit(
        sites, values, dtype=torch.float32, device=device, stats=stats), device)
    rec.update(stats)
    idx = rng.choice(N_TPS, N_TPS_CHECK, replace=False)
    pred, rec["eval_sites_s"] = _timed(lambda: rbf_pu.evaluate(m32, sites[idx]), device)
    rec["max_site_resid"] = float(np.abs(pred.double().cpu().numpy() - values[idx]).max())
    m64, rec["fit_f64_s"] = _timed(lambda: rbf_pu.fit(
        sites, values, dtype=torch.float64, device=device), device)
    pred = rbf_pu.evaluate(m64, sites[idx]).cpu().numpy()
    rec["max_site_resid_f64"] = float(np.abs(pred - values[idx]).max())
    q = np.random.default_rng(5).uniform(-1.0, 1.0, size=(N_TPS_CHECK, 2))
    a = rbf_pu.evaluate(m32, q).double().cpu().numpy()
    b = rbf_pu.evaluate(m64, q).cpu().numpy()
    rec["f32_vs_f64_max"] = float(np.abs(a - b).max())
    require(np.all(np.isfinite(a)), "tps_100k: non-finite values")
    require(rec["max_site_resid"] < TPS_SITE_RESID_MAX, f"tps_100k f32 site residual: {rec}")
    require(rec["max_site_resid_f64"] < TPS_SITE_RESID_F64_MAX,
            f"tps_100k f64 site residual: {rec}")
    del m64
    _profiled(rec, "profiled_fit_f32", lambda: rbf_pu.fit(
        sites, values, dtype=torch.float32, device=device))


def wendland_1m(rec, device="cuda"):
    """bench.py's wendland_1m: CompactRbf of 1,000,000 sites in float32
    (tol 1e-6, maxiter 400), a steady refit of the sites + 1e-7, and the
    site residual over 10,000 of them."""
    import torch

    from gsl_scattered_interpolation_torch.models import rbf_compact

    rng = np.random.default_rng(4)
    sites = rng.uniform(-1.0, 1.0, size=(N_WENDLAND, 2))
    values = np.sin(3 * sites[:, 0]) * np.cos(2 * sites[:, 1])
    kw = dict(tol=1e-6, maxiter=400, dtype=torch.float32, device=device)
    # The first fit is the profiled one: its device is busy more than 90 %
    # of the time, so the profiler's host cost does not show in its seconds.
    fit = []
    _profiled(rec, "profiled_fit", lambda: fit.append(
        rbf_compact.CompactRbf(sites, values, **kw)))
    m = fit[0]
    rec["fit_s"] = rec["profiled_fit"]["wall_s"]
    m2, rec["fit_steady_s"] = _timed(
        lambda: rbf_compact.CompactRbf(sites + 1e-7, values, **kw), device)
    rec.update(grid=list(m.grid.shape), cap=m.grid.cap, epsilon=m.epsilon,
               pcg_iters=m.cg_iters, pcg_iters_steady=m2.cg_iters,
               pcg_residual=m.cg_residual,
               pcg_rel_residual=m.cg_residual / float(np.linalg.norm(values)))
    del m2
    idx = rng.choice(N_WENDLAND, N_WENDLAND_CHECK, replace=False)
    pred, rec["eval_s"] = _timed(lambda: m.eval(sites[idx]), device)
    pred = pred.double().cpu().numpy()
    require(np.all(np.isfinite(pred)), "wendland_1m: non-finite values")
    rec["max_site_resid"] = float(np.abs(pred - values[idx]).max())
    require(rec["max_site_resid"] < WENDLAND_SITE_RESID_MAX, f"wendland_1m: {rec}")


def weights_4k(rec, device="cuda"):
    """bench.py's weights: CompactRbf of 4,096 sites in float32 against the
    host float64 dense solve, before and after refine(iters=3); a float64
    CompactRbf on the card as test_weight_accuracy.py runs it."""
    import torch

    from gsl_scattered_interpolation_torch.models import rbf_compact

    rng = np.random.default_rng(21)
    sites = rng.uniform(-0.5, 0.5, size=(N_WEIGHTS, 2))
    values = np.sin(3 * sites[:, 0]) * np.cos(2 * sites[:, 1])
    eps = 1.0 / float(np.sqrt(40.0 / (np.pi * N_WEIGHTS)))
    kw = dict(epsilon=eps, standardize=False, device=device)
    fit32 = functools.partial(rbf_compact.CompactRbf, sites, values, tol=1e-7,
                              maxiter=4000, dtype=torch.float32, **kw)
    m, rec["fit_s"] = _timed(fit32, device)
    lam32 = m.lam.double().cpu().numpy()
    t0 = time.perf_counter()
    diff = sites[:, None, :] - sites[None, :, :]
    t = eps * np.sqrt((diff**2).sum(-1))
    K = np.maximum(1.0 - t, 0.0) ** 4 * (4.0 * t + 1.0)
    lam64 = np.linalg.solve(K, values)
    rec["host_oracle_s"] = time.perf_counter() - t0
    scale = np.max(np.abs(lam64))
    rec["max_rel_weight_err_unrefined"] = float(np.max(np.abs(lam32 - lam64)) / scale)
    _, rec["refine_s"] = _timed(lambda: m.refine(iters=3), device)
    rec["max_rel_weight_err"] = float(np.max(np.abs(m.lam64 - lam64)) / scale)
    rec["max_system_resid"] = float(np.max(np.abs(K @ m.lam64 - values)))
    rec["refine_curve_max_resid"] = m.refine_history
    rec["pcg_iters"] = m.cg_iters
    m64, rec["fit_f64_s"] = _timed(lambda: rbf_compact.CompactRbf(
        sites, values, tol=1e-14, maxiter=8000, dtype=torch.float64, **kw), device)
    rec["pcg_iters_f64"] = m64.cg_iters
    rec["max_rel_weight_err_f64"] = float(
        np.max(np.abs(m64.lam.cpu().numpy() - lam64)) / scale)
    require(rec["max_rel_weight_err"] <= WEIGHTS_REFINED_MAX, f"weights refined: {rec}")
    require(rec["max_rel_weight_err_f64"] <= WEIGHTS_F64_MAX, f"weights f64: {rec}")
    _profiled(rec, "profiled_fit", fit32)


def kriging_100k(rec, device="cuda"):
    """bench.py's kriging_100k: LocalKriging(k_neighbors=24) of 100,000
    noisy sites in float32, a steady refit, 10^6 predictions with variances
    (a warm call, then a timed one on the queries + 1e-7); RMSE, variances,
    calibration, float32 against float64 with the same variogram, and
    scipy's RBFInterpolator(neighbors=24) on the same host."""
    import torch
    from scipy.interpolate import RBFInterpolator

    from gsl_scattered_interpolation_torch.models import kriging

    rng = np.random.default_rng(23)
    x = rng.uniform(0.0, 10.0, size=(N_KRIGING, 2))
    noise_sd = 0.05
    f_true = np.sin(x[:, 0] * 0.8) + 0.5 * np.cos(x[:, 1] * 1.1)
    f = f_true + noise_sd * rng.standard_normal(N_KRIGING)
    kw = dict(k_neighbors=24, dtype=torch.float32, device=device)
    m, rec["fit_s"] = _timed(lambda: kriging.LocalKriging(x, f, **kw), device)
    _, rec["fit_steady_s"] = _timed(lambda: kriging.LocalKriging(x + 1e-9, f, **kw), device)
    rec["variogram"] = list(m.variogram)
    rec["grid"] = list(m.grid.xs_pad.shape[:2])
    rec["cap"] = m.grid.cap
    q = rng.uniform(0.5, 9.5, size=(KRIGING_QUERIES, 2))
    qt = torch.tensor(q, dtype=torch.float32, device=device)
    _, rec["predict_warm_s"] = _timed(lambda: m.predict(qt, chunk=KRIGING_CHUNK), device)
    qt = torch.tensor(q + 1e-7, dtype=torch.float32, device=device)
    (mean, var), t_pred = _timed(lambda: m.predict(qt, chunk=KRIGING_CHUNK), device)
    rec["predict_1m_s"] = t_pred
    rec["queries_per_s"] = KRIGING_QUERIES / t_pred
    ref = np.sin(q[:, 0] * 0.8) + 0.5 * np.cos(q[:, 1] * 1.1)
    mean = mean.double().cpu().numpy()
    var = var.double().cpu().numpy()
    rec["rmse"] = float(np.sqrt(np.mean((mean - ref) ** 2)))
    rec["mean_variance"] = float(np.mean(var))
    # bench.py's calibration: squared errors against fresh noisy
    # observations over the mean kriging variance.
    y_new = ref + noise_sd * rng.standard_normal(KRIGING_QUERIES)
    rec["calibration"] = float(np.mean((mean - y_new) ** 2) / max(np.mean(var), 1e-30))
    m64 = kriging.LocalKriging(x, f, variogram=m.variogram, k_neighbors=24,
                               dtype=torch.float64, device=device)
    mean64, _ = m64.predict(q[:N_KRIGING_CHECK])
    rec["f32_vs_f64_max"] = float(np.abs(mean[:N_KRIGING_CHECK]
                                         - mean64.cpu().numpy()).max())
    t0 = time.perf_counter()
    cpu_m = RBFInterpolator(x, f, neighbors=24, kernel="linear")
    rec["cpu_scipy_fit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_m(q[:N_KRIGING_CHECK])
    rec["cpu_scipy_20k_s"] = time.perf_counter() - t0
    rec["cpu_scipy_qps"] = N_KRIGING_CHECK / rec["cpu_scipy_20k_s"]
    require(rec["rmse"] < KRIGING_RMSE_MAX, f"kriging_100k rmse: {rec}")
    require(bool(np.all(np.isfinite(var)) and np.all(var >= 0)), "kriging_100k variances")
    require(0.5 <= rec["calibration"] <= 2.0, f"kriging_100k calibration: {rec}")
    require(rec["f32_vs_f64_max"] < KRIGING_F32_VS_F64_MAX, f"kriging_100k f32 vs f64: {rec}")
    _profiled(rec, "profiled_fit", lambda: kriging.LocalKriging(x, f, **kw))
    _profiled(rec, "profiled_predict_chunk",
              lambda: m.predict(qt[:KRIGING_CHUNK], chunk=KRIGING_CHUNK))


def rbf_direct(rec, device="cuda"):
    """RbfInterp(kernel="thin_plate") of 8,192 sites, the largest that
    solver="auto" solves directly: float64 (gated at the sites) and
    float32; solver="pcg" on the same sites in float64 against the direct
    values; then pcg at 50,000 sites in float64."""
    import torch

    from gsl_scattered_interpolation_torch.models import rbf

    rng = np.random.default_rng(31)
    sites = rng.uniform(-1.0, 1.0, size=(N_DIRECT, 2))
    values = np.sin(3 * sites[:, 0]) * np.cos(2 * sites[:, 1]) + sites[:, 1]
    q = rng.uniform(-1.0, 1.0, size=(N_DIRECT_CHECK, 2))
    fit = functools.partial(rbf.RbfInterp, sites, values, kernel="thin_plate", device=device)
    d64, rec["fit_f64_s"] = _timed(lambda: fit(dtype=torch.float64), device)
    require(d64.solver == "direct", f"auto picked {d64.solver}")
    rec["max_site_resid_f64"] = float(d64.residual())
    d32, rec["fit_f32_s"] = _timed(lambda: fit(dtype=torch.float32), device)
    rec["max_site_resid_f32"] = float(d32.residual())
    del d32
    p64, rec["pcg_fit_s"] = _timed(lambda: fit(dtype=torch.float64, solver="pcg"), device)
    rec["pcg_matvecs"] = p64.solve_info["iters"]
    rec["pcg_rel_residual"] = p64.solve_info["rel_residual"]
    a = p64.eval(q).cpu().numpy()
    b = d64.eval(q).cpu().numpy()
    rec["pcg_vs_direct_max"] = float(np.abs(a - b).max())
    require(np.all(np.isfinite(a)), "rbf_direct: non-finite pcg values")
    require(rec["max_site_resid_f64"] < DIRECT_SITE_RESID_F64_MAX, f"rbf_direct f64: {rec}")
    require(rec["pcg_vs_direct_max"] < PCG_VS_DIRECT_MAX, f"rbf_direct pcg: {rec}")
    del d64, p64
    _profiled(rec, "profiled_pcg_fit", lambda: fit(dtype=torch.float64, solver="pcg"))
    big = np.random.default_rng(32).uniform(-1.0, 1.0, size=(N_PCG_LARGE, 2))
    vb = np.sin(3 * big[:, 0]) * np.cos(2 * big[:, 1]) + big[:, 1]
    m, rec["pcg_50k_fit_s"] = _timed(lambda: rbf.RbfInterp(
        big, vb, kernel="thin_plate", solver="pcg", cg_maxiter=PCG_LARGE_MAXITER,
        dtype=torch.float64, device=device), device)
    rec["pcg_50k_matvecs"] = m.solve_info["iters"]
    rec["pcg_50k_rel_residual"] = m.solve_info["rel_residual"]


RBF_CONFIGS = (("tps_100k", tps_100k), ("wendland_1m", wendland_1m),
               ("weights", weights_4k), ("kriging_100k", kriging_100k),
               ("rbf_direct", rbf_direct))


def phase_rbf(device="cuda"):
    """The RBF phase: each configuration of RBF_CONFIGS counted from zero
    (neither kernel is on it), after checking that float32 matmuls run in
    full float32.  Returns {name: record}."""
    import torch

    require(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are on")
    require(torch.get_float32_matmul_precision() == "highest",
            f"float32 matmul precision {torch.get_float32_matmul_precision()}")
    out = {}
    for name, body in RBF_CONFIGS:
        out[name] = _config(name, device, functools.partial(body, device=device))
    return out


# The structured phase: the GSL 1D/2D family (the tridiagonal kernel), the
# locate kernel's boundary check at T ~ 101,000, and the geometry consumers.
GOLDEN = "tests/golden/gsl_interp_golden.json"
KINDS_1D = ("linear", "polynomial", "cspline", "cspline_periodic", "akima",
            "akima_periodic", "steffen")
N_1D = 1_000_000           # knots of gsl1d_1m
Q_1D = 10_000_000          # queries per operation
N_INTEG = 1_000_000        # intervals integrated
N_POLY = 16                # the polynomial kind's knots
N_STRUCT_CHECK = 100_000   # sampled queries held against scipy
N_2D = 2048                # gsl2d_2k's grid is N_2D x N_2D
Q_2D = 10_000_000
N_BOUNDARY = 50_500        # bench.py:615: ~2n triangles, T just above 100k
Q_BOUNDARY = 50_000
N_GEOM = N_BUILD           # the 200k sites of BUILD_SEED
Q_GEOM = 1_000_000
N_THIN = 200_000
THIN_TOL = 1e-3
ALPHA_AXIS = 49            # nodes per axis of alpha_ball's jittered grid
SPLINE_VS_SCIPY_MAX = 1e-9   # relative to max |y|
KNOTS_MAX = 1e-12
THIN_SLACK = {"float32": 1e-5, "float64": 1e-12}
# The kernel's Thomas sweeps against cuSOLVER's dense LU with pivoting on
# the bicubic derivative grid: both backward stable on a diagonally
# dominant matrix (condition number below 3), so they agree far inside
# 1e-12 of max |x|.
TRIDIAG_VS_LIBRARY_MAX = 1e-12
# The two routes against each other, relative to max |x|: the CPU tests'
# tolerances against JAX (tests/test_torch_tridiag.py).
TRIDIAG_ROUTES_MAX = {"float64": 1e-14, "float32": 4 * 2.0**-23}


def tridiag_bound_ms(n: int, m: int, double: bool):
    """(least ms, "bytes" or "operations") of one [n, m] Thomas solve:
    diag and offdiag read once, rhs read and x written once;
    tridiag.OPS_PER_ROW operations per row and column."""
    from gsl_scattered_interpolation_torch.ops import tridiag

    fb = 8 if double else 4
    bytes_ms = 1e3 * fb * ((2 * n - 1) + 2 * n * m) / HBM_BYTES_PER_S
    rate = F64_OPS_PER_S if double else F32_OPS_PER_S
    ops_ms = 1e3 * tridiag.OPS_PER_ROW * n * m / rate
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def partitioned_traffic_bytes(n: int, m: int, double: bool):
    """Bytes the partitioned route moves for one [n, m] solve, each array
    counted once for each kernel that touches it: per level, the factor
    reads d, e and writes R, C, VL, VR; the sweep reads e, R, C and b and
    writes Y (for m of 1 or 2 one kernel reads d, e, b and writes VL, VR,
    Y); the assembly reads the separators' d, e, b and their neighbours'
    Y and spikes and writes D, E, B; the back-fill reads Y, VL, VR and X
    and writes x; the last level's sequential solve reads d, e, b and
    writes and reads back c' and x.  Beside the bound, not in it."""
    from gsl_scattered_interpolation_torch.ops import tridiag

    plan = tridiag.partition_plan(n)
    vals = 0
    for rows, nb in zip(plan, plan[1:]):
        inner = (tridiag.BLOCK - 1) * nb
        if m <= 2:
            vals += 2 * rows + rows * m + 2 * inner + inner * m  # both
        else:
            vals += 2 * rows + 4 * inner                    # factor
            vals += rows + 2 * inner + rows * m + inner * m  # sweep
        vals += 4 * nb + 3 * nb * m + 2 * nb + nb * m   # assembly
        vals += inner * m + 2 * inner + nb * m + rows * m  # back-fill
    last = plan[-1]
    vals += 2 * last + 6 * last * m
    return (8 if double else 4) * vals


class Solve(NamedTuple):
    route: str          # "sequential" or "partitioned"
    diag: object
    offdiag: object
    rhs: object
    x: object
    kernels: int        # CUDA kernels the solve launched


class Recorder:
    """Within ``with``, keep every solve of the two tridiagonal wrappers
    (``tridiag.thomas_cuda`` and ``tridiag.partitioned_cuda``, which still
    count them) as a :class:`Solve`, so each can be held against its
    route's plain version on exactly what the main path gave it."""

    WRAPPERS = {"sequential": "thomas_cuda", "partitioned": "partitioned_cuda"}
    COUNTERS = ("launches", "kernel_launches")

    def __enter__(self):
        from gsl_scattered_interpolation_torch.ops import tridiag

        self.calls, self._swapped = [], []
        for route, name in self.WRAPPERS.items():
            orig = getattr(tridiag, name)

            def recording(diag, offdiag, rhs, *args, _route=route, _orig=orig, _name=name):
                counted = getattr(tridiag, _name)  # this function, while swapped in
                before = getattr(counted, "kernel_launches", counted.launches)
                x = _orig(diag, offdiag, rhs, *args)
                kernels = getattr(counted, "kernel_launches", counted.launches) - before
                self.calls.append(Solve(_route, diag, offdiag, rhs, x, kernels))
                return x

            # The wrappers count on the module's names, so the counts run
            # on ``recording`` meanwhile and go back to the wrapper on exit.
            for c in self.COUNTERS:
                if hasattr(orig, c):
                    setattr(recording, c, getattr(orig, c))
            setattr(tridiag, name, recording)
            self._swapped.append((name, orig, recording))
        return self

    def __exit__(self, *exc):
        from gsl_scattered_interpolation_torch.ops import tridiag

        for name, orig, recording in self._swapped:
            for c in self.COUNTERS:
                if hasattr(orig, c):
                    setattr(orig, c, getattr(recording, c))
            setattr(tridiag, name, orig)
        return False


# The sequential route's plain version is a Python loop of ~10 launches
# per row: held on the card up to this many rows.
SEQ_PLAIN_MAX_ROWS = 10_000


def tridiag_record(solve, label, reps=5, library=False):
    """One system the main path solved: its result held against the plain
    version of the route it took, on the card; both routes' kernels timed
    (CUDA events around back-to-back calls; the partitioned route also
    queued while the card sleeps, the sequential route so only up to
    ``SEQ_PLAIN_MAX_ROWS``) and held against their plain versions where
    these fit (the sequential plain version up to the same); the bound, and the partitioned route's own
    traffic beside it.  With ``library``, also ``torch.linalg.solve`` on the
    dense matrix (built outside the timed calls), timed as the library
    call."""
    import torch

    from gsl_scattered_interpolation_torch.ops import tridiag

    diag, offdiag, rhs = solve.diag, solve.offdiag, solve.rhs
    n, m = rhs.shape
    double = rhs.dtype == torch.float64
    rec = {"system": label, "n": int(n), "m": int(m),
           "dtype": str(rhs.dtype).split(".")[-1], "route": solve.route,
           "kernels_per_solve": solve.kernels}
    rec["bound_ms"], rec["bound_by"] = tridiag_bound_ms(n, m, double)
    traffic = partitioned_traffic_bytes(n, m, double)
    runs = {"partitioned": (tridiag.partitioned_cuda, tridiag.partitioned_ref),
            "sequential": (tridiag.thomas_cuda, tridiag.thomas_ref)}
    results = {}
    for route, (kernel, plain) in runs.items():
        r = {}
        got = kernel(diag, offdiag, rhs)
        if route == solve.route:
            r["equals_main_path"] = bool(torch.equal(got, solve.x))
        if route == "partitioned" or n <= SEQ_PLAIN_MAX_ROWS:
            t0 = time.perf_counter()
            ref = plain(diag, offdiag, rhs)
            sync(rhs.device.type)
            r["plain_ms"] = 1e3 * (time.perf_counter() - t0)
            r["mismatches"] = int((got != ref).sum())
            r["max_abs_err"] = float((got - ref).abs().max())
            del ref
        # One timed call of the sequential route at 10^6 rows (0.24-0.42 s).
        r["ms"] = time_ms(lambda: kernel(diag, offdiag, rhs),
                          reps if route == "partitioned" or n <= SEQ_PLAIN_MAX_ROWS else 1)
        if route == "partitioned" or n <= SEQ_PLAIN_MAX_ROWS:
            r["device_ms"] = kernel_ms(lambda: kernel(diag, offdiag, rhs), reps)
        if route == "partitioned":
            r["traffic_bytes"] = traffic
            r["traffic_ms"] = 1e3 * traffic / HBM_BYTES_PER_S
        results[route] = got
        rec[route] = r
    scale = float(results["sequential"].abs().max())
    rec["routes_max_rel_diff"] = float(
        (results["partitioned"] - results["sequential"]).abs().max()) / scale
    del results
    if library:
        dense = torch.diag(diag) + torch.diag(offdiag, 1) + torch.diag(offdiag, -1)
        lib = torch.linalg.solve(dense, rhs)
        rec["library_max_rel_err"] = float((lib - solve.x).abs().max() / solve.x.abs().max())
        rec["library_ms"] = time_ms(lambda: torch.linalg.solve(dense, rhs), reps)
        del dense, lib
        require(rec["library_max_rel_err"] <= TRIDIAG_VS_LIBRARY_MAX,
                f"tridiag disagrees with torch.linalg.solve: {rec}")
    log(f"tridiag kernels: {json.dumps(rec)}")
    require(rec[solve.route]["equals_main_path"], f"tridiag: a rerun differs: {rec}")
    for route in runs:
        require(rec[route].get("mismatches", 0) == 0,
                f"tridiag {route} disagrees with its plain version: {rec}")
    require(rec["routes_max_rel_diff"] <= TRIDIAG_ROUTES_MAX[rec["dtype"]],
            f"tridiag routes disagree: {rec}")
    return rec


def tridiag_profiled_ms(rows):
    """Device ms of the tridiagonal kernels (both routes) in a profile's
    {kernel name: (count, ms)}."""
    return sum(ms for name, (_, ms) in rows.items()
               if "thomas_kernel" in name or "part_" in name)


def gsl_golden(rec, device="cuda"):
    """Every 1D kind and both 2D kinds in float64 on the card against the
    compiled reference GSL (tests/golden/gsl_interp_golden.json) at the
    JAX package's test tolerances (tests/test_gsl_golden.py)."""
    import os

    import torch

    import gsl_scattered_interpolation_torch as gsi
    from gsl_scattered_interpolation_torch.utils import testing

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), GOLDEN)
    with open(path) as f:
        g = json.load(f)
    x, y, q = (np.asarray(g[k]) for k in ("x", "y", "q"))
    kw = dict(device=device, dtype=torch.float64)
    worst = {}
    solves = []  # (label, Solve) of every tridiagonal solve of the inits
    for kind in KINDS_1D:
        with Recorder() as recd:
            it = _main_run(rec, lambda: gsi.interp(x, y, kind, **kw))
        solves += [(f"golden_{kind}", c) for c in recd.calls]
        got = _main_run(rec, lambda: {
            "eval": it.eval(q), "deriv": it.eval_deriv(q), "deriv2": it.eval_deriv2(q),
            "integ": it.eval_integ(x[0], q)})
        tols = {"eval": 1e-10, "deriv": 1e-9, "deriv2": 1e-8,
                "integ": 1e-6 if kind == "polynomial" else 1e-10}
        for op, v in got.items():
            v = v.cpu().numpy()
            testing.test_abs(v, g[kind][op], tols[op], f"golden {kind} {op}")
            worst[f"{kind}.{op}"] = float(np.nanmax(np.abs(v - np.asarray(g[kind][op]))))
    gx = np.array([0.0, 0.7, 1.5, 2.6, 3.1])
    gy = np.array([-1.0, -0.2, 0.9, 2.0])
    i, j = np.arange(5)[:, None], np.arange(4)[None, :]
    z = (i * 0.37 - j * 0.81) * (i + 0.5 * j) + 1.0
    k = np.arange(25)
    qx = gx[0] + (gx[-1] - gx[0]) * k / 24.0
    qy = gy[0] + (gy[-1] - gy[0]) * ((k * 7) % 25) / 24.0
    for kind in ("bilinear", "bicubic"):
        with Recorder() as recd:
            it = _main_run(rec, lambda: gsi.interp2d(gx, gy, z, kind, **kw))
        solves += [(f"golden_{kind}_{i}", c) for i, c in enumerate(recd.calls)]
        for op, fn, tol in (("eval", it.eval, 1e-10), ("deriv_x", it.eval_deriv_x, 1e-9),
                            ("deriv_y", it.eval_deriv_y, 1e-9)):
            v = _main_run(rec, lambda: fn(qx, qy)).cpu().numpy()
            testing.test_abs(v, g[kind][op], tol, f"golden {kind} {op}")
            worst[f"{kind}.{op}"] = float(np.abs(v - np.asarray(g[kind][op])).max())
    rec["max_abs_err"] = worst
    rec["tridiag_solves"] = len(solves)
    # Each solve held bit for bit against its route's plain version, on
    # what the init gave the wrapper.
    rec["tridiag_kernel"] = [tridiag_record(c, label, library=True) for label, c in solves]


def newton_terms_scale(dd, x):
    """The largest sum over k of |dd_k| prod_{j<k} |t - x_j| at the knots
    t = x: the magnitude of the terms Horner's rule adds up there."""
    diff = np.abs(x[:, None] - x[None, :])  # [t, j]
    prods = np.concatenate([np.ones((x.size, 1)), np.cumprod(diff, axis=1)[:, :-1]], 1)
    return float((np.abs(dd)[None, :] * prods).sum(1).max())


def _qps(fn, n, device):
    out, s = _timed(fn, device)
    return out, {"s": s, "queries_per_s": n / s}


def gsl1d_1m(rec, device="cuda"):
    """10^6 knots in float64: every kind's init (timed; the tridiagonal
    kernels' device share from a profiled init), eval, eval_deriv and
    eval_deriv2 of 10^7 queries and eval_integ of 10^6 intervals, held
    against numpy and scipy on 10^5 sampled queries; the polynomial kind
    at 16 knots."""
    import torch
    from scipy.interpolate import Akima1DInterpolator, CubicSpline

    import gsl_scattered_interpolation_torch as gsi

    rng = np.random.default_rng(41)
    x = np.cumsum(rng.uniform(0.5, 1.5, N_1D))
    y = rng.normal(size=N_1D)
    yp = y.copy()
    yp[-1] = yp[0]
    f64 = dict(device=device, dtype=torch.float64)
    gen = torch.Generator(device=device).manual_seed(44)
    q = x[0] + (x[-1] - x[0]) * torch.rand(Q_1D, generator=gen, **f64)
    qs = q[:N_STRUCT_CHECK].cpu().numpy()
    knots = np.sort(rng.choice(N_1D, N_STRUCT_CHECK, replace=False))
    ymax = float(np.abs(y).max())
    for kind in KINDS_1D:
        r = {}
        if kind == "polynomial":
            kx, ky = x[:N_POLY], y[:N_POLY]
            qk = kx[0] + (kx[-1] - kx[0]) * torch.rand(Q_1D, generator=gen, **f64)
        else:
            kx, ky = x, (yp if kind.endswith("periodic") else y)
            qk = q
        lo = torch.minimum(qk[:N_INTEG], qk[N_INTEG:2 * N_INTEG])
        hi = torch.maximum(qk[:N_INTEG], qk[N_INTEG:2 * N_INTEG])
        with Recorder() as recd:
            it, r["init_s"] = _main_run(rec, lambda: _timed(
                lambda: gsi.interp(kx, ky, kind, **f64), device))
        r["tridiag_solves"] = len(recd.calls)
        r["tridiag_kernels_per_solve"] = [c.kernels for c in recd.calls]
        for op in ("eval", "eval_deriv", "eval_deriv2"):
            _, r[op] = _main_run(rec, lambda: _qps(lambda: getattr(it, op)(qk), Q_1D, device))
        ik, r["eval_integ"] = _main_run(rec, lambda: _qps(
            lambda: it.eval_integ(lo, hi), N_INTEG, device))
        require(bool(torch.isfinite(ik).all()), f"gsl1d {kind}: non-finite integrals")
        at = np.arange(kx.size) if kind == "polynomial" else knots
        r["knots_max_err"] = float(np.abs(it.eval(kx[at]).cpu().numpy() - ky[at]).max())
        scale = max(1.0, ymax)
        if kind == "polynomial":
            # Horner's sum of the Newton form cancels: at 16 knots its
            # terms reach ~3e7 while y is O(1) (JAX's evaluation misses the
            # knots by the same 7.8e-10), so the knots are held to the
            # terms' magnitude.
            scale = newton_terms_scale(it.dd.cpu().numpy(), kx)
        require(r["knots_max_err"] <= KNOTS_MAX * scale, f"gsl1d {kind} knots: {r}")
        if kind.startswith("cspline"):
            require(len(recd.calls) == 1, f"{kind}: {len(recd.calls)} tridiagonal solves")
            r["tridiag_kernel"] = tridiag_record(recd.calls[0], f"gsl1d_{kind}", reps=3)
            busy, wall, rows = profile_build(lambda: gsi.interp(kx, ky, kind, **f64))
            k_ms = tridiag_profiled_ms(rows)
            r["profiled_init"] = {"wall_s": wall / 1e3, "device_busy_ms": busy,
                                  "tridiag_kernel_ms": k_ms,
                                  "tridiag_share": k_ms / wall}
            cs = CubicSpline(kx, ky, bc_type="natural" if kind == "cspline" else "periodic")
            F = cs.antiderivative()
            a_s = lo[:N_STRUCT_CHECK].cpu().numpy()
            b_s = hi[:N_STRUCT_CHECK].cpu().numpy()
            errs = {
                "eval": np.abs(it.eval(qs).cpu().numpy() - cs(qs)).max(),
                "deriv": np.abs(it.eval_deriv(qs).cpu().numpy() - cs(qs, 1)).max(),
                "deriv2": np.abs(it.eval_deriv2(qs).cpu().numpy() - cs(qs, 2)).max(),
                "integ": np.abs(it.eval_integ(a_s, b_s).cpu().numpy() - (F(b_s) - F(a_s))).max(),
            }
            r["vs_scipy_rel"] = {k: float(v) / ymax for k, v in errs.items()}
        elif kind == "linear":
            r["vs_numpy"] = float(np.abs(it.eval(qs).cpu().numpy() - np.interp(qs, x, y)).max())
            require(r["vs_numpy"] <= 1e-12, f"gsl1d linear vs np.interp: {r}")
        elif kind == "akima":
            inner = qs[(qs > x[4]) & (qs < x[-5])]
            ak = Akima1DInterpolator(x, y)
            r["vs_scipy_rel"] = {"eval": float(np.abs(it.eval(inner).cpu().numpy()
                                                      - ak(inner)).max()) / ymax}
        elif kind == "steffen":
            ym = np.cumsum(np.abs(y))  # monotone data on the same knots
            mono = gsi.interp(x, ym, "steffen", **f64)
            v = mono.eval(np.sort(qs)).cpu().numpy()
            r["monotone_min_step"] = float(np.diff(v).min())
            require(r["monotone_min_step"] >= 0.0, f"steffen not monotone: {r}")
        for k, v in r.get("vs_scipy_rel", {}).items():
            require(v <= SPLINE_VS_SCIPY_MAX, f"gsl1d {kind} {k} vs scipy: {r}")
        rec[kind] = r
        del it


def gsl2d_2k(rec, device="cuda"):
    """A 2,048 x 2,048 grid in float64: bilinear and bicubic init (three
    solves of m = 2,048 for bicubic, each held against the plain
    versions), eval and all five derivatives of 10^7 queries; bilinear
    against scipy, bicubic's nodes and its zx against scipy's natural
    cubic splines."""
    import torch
    from scipy.interpolate import CubicSpline, RegularGridInterpolator

    import gsl_scattered_interpolation_torch as gsi

    rng = np.random.default_rng(43)
    gx = np.cumsum(rng.uniform(0.5, 1.5, N_2D))
    gy = np.cumsum(rng.uniform(0.5, 1.5, N_2D))
    z = np.sin(gx / 40.0)[:, None] * np.cos(gy / 30.0)[None, :] + 0.1 * rng.normal(size=(N_2D, N_2D))
    f64 = dict(device=device, dtype=torch.float64)
    gen = torch.Generator(device=device).manual_seed(46)
    xq = gx[0] + (gx[-1] - gx[0]) * torch.rand(Q_2D, generator=gen, **f64)
    yq = gy[0] + (gy[-1] - gy[0]) * torch.rand(Q_2D, generator=gen, **f64)
    qn = np.stack([xq[:N_STRUCT_CHECK].cpu().numpy(), yq[:N_STRUCT_CHECK].cpu().numpy()], -1)
    zmax = float(np.abs(z).max())
    recs = []
    for kind in ("bilinear", "bicubic"):
        r = {}
        with Recorder() as recd:
            it, r["init_s"] = _main_run(rec, lambda: _timed(
                lambda: gsi.interp2d(gx, gy, z, kind, **f64), device))
        r["tridiag_solves"] = len(recd.calls)
        r["tridiag_kernels_per_solve"] = [c.kernels for c in recd.calls]
        for op in ("eval", "eval_deriv_x", "eval_deriv_y", "eval_deriv_xx",
                   "eval_deriv_xy", "eval_deriv_yy"):
            v, r[op] = _main_run(rec, lambda: _qps(lambda: getattr(it, op)(xq, yq), Q_2D, device))
            require(bool(torch.isfinite(v).all()), f"gsl2d {kind} {op}: non-finite")
            del v
        if kind == "bilinear":
            ref = RegularGridInterpolator((gx, gy), z, method="linear")(qn)
            r["vs_scipy"] = float(np.abs(it.eval(qn[:, 0], qn[:, 1]).cpu().numpy() - ref).max())
            require(r["vs_scipy"] <= 1e-12 * max(1.0, zmax), f"gsl2d bilinear vs scipy: {r}")
        else:
            require(len(recd.calls) == 3, f"bicubic: {len(recd.calls)} tridiagonal solves")
            for label, call in zip(("zx", "zy", "zxy"), recd.calls):
                recs.append(tridiag_record(call, f"gsl2d_{label}", reps=5,
                                           library=label == "zx"))
            busy, wall, rows = profile_build(lambda: gsi.interp2d(gx, gy, z, kind, **f64))
            k_ms = tridiag_profiled_ms(rows)
            r["profiled_init"] = {"wall_s": wall / 1e3, "device_busy_ms": busy,
                                  "tridiag_kernel_ms": k_ms, "tridiag_share": k_ms / wall}
            ii = rng.choice(N_2D, 64, replace=False)
            jj = rng.choice(N_2D, 64, replace=False)
            nodes = it.eval(gx[ii][:, None].repeat(64, 1).ravel(),
                            np.tile(gy[jj], 64)).cpu().numpy().reshape(64, 64)
            r["nodes_max_err"] = float(np.abs(nodes - z[np.ix_(ii, jj)]).max())
            require(r["nodes_max_err"] <= KNOTS_MAX * max(1.0, zmax), f"gsl2d nodes: {r}")
            cols = rng.choice(N_2D, 16, replace=False)
            zx = it.zx[:, torch.as_tensor(cols, device=device)].cpu().numpy()
            ref = np.stack([CubicSpline(gx, z[:, c], bc_type="natural")(gx, 1) for c in cols], -1)
            r["zx_vs_scipy_rel"] = float(np.abs(zx - ref).max()) / zmax
            require(r["zx_vs_scipy_rel"] <= SPLINE_VS_SCIPY_MAX, f"gsl2d zx vs scipy: {r}")
            busy, wall, _ = profile_build(lambda: it.eval(xq[:BATCH], yq[:BATCH]))
            r["profiled_eval_1m"] = {"wall_s": wall / 1e3, "device_busy_ms": busy,
                                     "device_idle_share": 1.0 - busy / wall}
        rec[kind] = r
        del it
    rec["tridiag_kernel"] = recs


def boundary_problem():
    """bench.py:599-647's sites and queries (numpy float64)."""
    rng = np.random.default_rng(42)
    sites = rng.uniform(-0.5, 0.5, size=(N_BOUNDARY, 2))
    return sites, rng.uniform(-0.45, 0.45, size=(Q_BOUNDARY, 2))


def boundary_100k(rec, device="cuda"):
    """bench.py:599-647: the locate kernel at T ~ 101,000 against
    locate_dense on a Qhull import of 50,500 sites cast to float32, 50,000
    queries; index mismatch < 1 %, value difference < 1e-3."""
    import torch
    from scipy.spatial import Delaunay

    from gsl_scattered_interpolation_torch.models import device_tri
    from gsl_scattered_interpolation_torch.models import geometry_extras as gx
    from gsl_scattered_interpolation_torch.ops import locate

    sites, q_np = boundary_problem()
    t0 = time.perf_counter()
    sd = Delaunay(sites)
    rec["qhull_s"] = time.perf_counter() - t0
    tri32, rec["import_s"] = _main_run(rec, lambda: _timed(
        lambda: gx.from_scipy_delaunay(sd, sites, device=device).cast(torch.float32), device))
    rec["n_tris"] = int(tri32.n_tris)
    require(tri32.n_tris >= 100_000, f"T = {tri32.n_tris}")
    q = torch.tensor(q_np, dtype=torch.float32, device=device)
    before = rec["main_launches"]["locate2d"], rec["main_kernels"]["locate2d"]
    idx_p = _main_run(rec, lambda: locate.locate_dense_kernel(tri32, q))
    rec["kernel_launches"] = rec["main_launches"]["locate2d"] - before[0]
    rec["cuda_kernels"] = rec["main_kernels"]["locate2d"] - before[1]
    idx_d = device_tri.locate_dense(tri32, q)[0]
    vals = np.sin(3 * sites[:, 0]) * np.cos(2 * sites[:, 1])
    resp = torch.cat([torch.zeros(3, device=device),
                      torch.tensor(vals, dtype=torch.float32, device=device)])
    resp_tri = device_tri.vertex_responses(tri32, resp)[:, :3]
    out_p = (resp_tri[idx_p.long()] * device_tri._weights(tri32, idx_p.long(), q)).sum(-1)
    out_d = (resp_tri[idx_d.long()] * device_tri._weights(tri32, idx_d.long(), q)).sum(-1)
    rec["mismatch_rate"] = float((idx_p.long() != idx_d.long()).float().mean())
    rec["max_interp_diff"] = float((out_p - out_d).abs().max())
    require(rec["mismatch_rate"] < LEAF_MISMATCH_MAX, f"boundary mismatch: {rec}")
    require(rec["max_interp_diff"] < EVAL_VS_DENSE_MAX, f"boundary diff: {rec}")
    rec["kernel"] = check_locate(tri32, q)


def geometry_200k(rec, device="cuda"):
    """Hull, Voronoi and serialize on the 200k sites of BUILD_SEED: the
    hull of their Qhull import equal to scipy's ConvexHull, and the hull of
    their float64 device build a superset of it (the finite cage can cut
    off thin triangles along the hull, which leaves a near-hull site
    beside a cage triangle: the JAX package's rule, recorded); each Voronoi
    vertex of the device build equidistant from its three sites within
    1e-9 relative, or within its own rounding bound where that is larger;
    a
    save/load round trip whose eval of 10^6 queries is bit-equal."""
    import os
    import tempfile

    import torch
    from scipy.spatial import ConvexHull, Delaunay

    from gsl_scattered_interpolation_torch.models import device_delaunay as dd
    from gsl_scattered_interpolation_torch.models import device_tri
    from gsl_scattered_interpolation_torch.models import geometry_extras as gx
    from gsl_scattered_interpolation_torch.models import host_tree
    from gsl_scattered_interpolation_torch.utils import serialize

    sites = np.random.default_rng(BUILD_SEED).uniform(-0.5, 0.5, size=(N_GEOM, 2))
    ref = np.sort(ConvexHull(sites).vertices)
    sd = Delaunay(sites)
    imported = _main_run(rec, lambda: gx.from_scipy_delaunay(sd, sites, device=device))
    hull, rec["hull_s"] = _main_run(rec, lambda: _timed(
        lambda: gx.convex_hull_points(imported), device))
    rec["hull_points"] = int(hull.size)
    require(np.array_equal(hull, ref), "the Qhull import's hull differs from scipy's")
    (tri, shuffle), rec["build_s"] = _main_run(rec, lambda: _timed(lambda: dd.triangulate(
        sites, flags=host_tree.NOSTANDARDIZE, dtype=torch.float64, device=device), device))
    native = np.sort(shuffle[_main_run(rec, lambda: gx.convex_hull_points(tri))])
    rec["native_hull_extra_points"] = int(np.setdiff1d(native, ref).size)
    require(np.isin(ref, native).all(), "the device build's hull misses a hull point")
    (centers, ridges), rec["voronoi_s"] = _main_run(rec, lambda: _timed(
        lambda: gx.voronoi(tri), device))
    tv = tri.tri_verts.cpu().numpy()
    data = (tv > 2).all(1)
    rec["voronoi_vertices"], rec["voronoi_ridges"] = int(centers.shape[0]), int(ridges.shape[0])
    require(centers.shape[0] == int(data.sum()), "Voronoi vertices != all-data triangles")
    pts = tri.points_std.cpu().numpy()[tv[data]]
    dist = np.linalg.norm(pts - centers[:, None, :], axis=-1)
    rel = (dist.max(1) - dist.min(1)) / dist.max(1)
    # The centre solves v_i - v_{i+1} . c = (|v_i|^2 - |v_{i+1}|^2) / 2 in
    # absolute coordinates (JAX's formulation): the right side cancels,
    # so a triangle's relative error is about eps kappa |v|^2 / R^2, 7e-8
    # for the smallest (R ~ 8e-5) of 200k sites in the unit square.  Each
    # centre is held to 1e-9 or 4 times that rounding bound if larger.
    # tools/voronoi_equidistance.py reads the JAX package's circumsphere on
    # the Delaunay triangles of these sites on the CPU: the same worst
    # 4.19e-9 with the same 10 triangles over 1e-9, the port's centres
    # equal to JAX's, and 4.2e-13 for the system solved relative to a
    # vertex.
    kappa = np.linalg.cond(pts[:, :2, :] - pts[:, 1:, :])
    bound = np.maximum(1e-9, 4 * np.finfo(np.float64).eps * kappa
                       * (pts ** 2).sum(-1).max(1) / dist.max(1) ** 2)
    rec["equidistance_rel"] = float(rel.max())
    rec["equidistance_over_1e-9"] = int((rel > 1e-9).sum())
    rec["equidistance_vs_bound"] = float((rel / bound).max())
    require(bool(np.all(rel <= bound)), f"Voronoi centres: {rec}")
    busy, wall, _ = profile_build(lambda: gx.voronoi(tri))
    rec["profiled_voronoi"] = {"wall_s": wall / 1e3, "device_busy_ms": busy,
                               "device_idle_share": 1.0 - busy / wall}
    resp = device_tri.response_for_build(shuffle, np.sin(6 * sites[:, 0]), device=device)
    q = uniform_queries(Q_GEOM, seed=5, device=device)[0].double()
    before = _main_run(rec, lambda: device_tri.interp(tri, resp, q))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tri.npz")
        _, rec["save_s"] = _main_run(rec, lambda: _timed(
            lambda: serialize.save(path, tri, resp), device))
        rec["file_MB"] = os.path.getsize(path) / 1e6
        (tri2, resp2), rec["load_s"] = _main_run(rec, lambda: _timed(
            lambda: serialize.load(path, device=device), device))
    after = _main_run(rec, lambda: device_tri.interp(tri2, resp2, q))
    require(bool(torch.equal(before, after)), "eval differs after save/load")


def _thin_contract(res, sites, vals, native: bool):
    """The largest miss at a dropped site by scipy's LinearNDInterpolator
    over the kept sites, as the kept triangulation defines the
    interpolant: with the cage's vertices at value 0 for a native build
    (its fade to zero beyond the hull), 0 beyond the hull for a Qhull
    import."""
    from scipy.interpolate import LinearNDInterpolator

    drop = np.setdiff1d(np.arange(len(sites)), res.keep)
    kept, kv = sites[res.keep], vals[res.keep]
    if native:
        cage = res.tri.points_raw[:3].double().cpu().numpy()
        kept, kv = np.concatenate([cage, kept]), np.concatenate([np.zeros(3), kv])
    est = LinearNDInterpolator(kept, kv, fill_value=0.0)(sites[drop])
    return float(np.abs(est - vals[drop]).max())


class RoundClock:
    """Within ``with``, time each call of ``device_tri.interp`` (one thin
    round's evaluation of its dropped sites), the card synchronised before
    and after, and the time from the end of the previous call (or from
    entry) to its start: the round's build and its host bookkeeping.
    ``largest`` keeps (triangulation, queries) of the round with the most
    pairs among those that the locate kernel serves (float32, T <=
    PALLAS_LOCATE_MAX_TRIS)."""

    def __enter__(self):
        from gsl_scattered_interpolation_torch.models import device_tri

        self.rounds, self._orig = [], device_tri.interp
        self._last = time.perf_counter()
        self.largest, pairs = None, 0

        def keep(tri, q):
            nonlocal pairs
            n = q.shape[0] * tri.n_tris
            if (device_tri.auto_method(q.device.type, tri.dim, tri.dtype, tri.n_tris, False)
                    == "pallas" and n > pairs):
                self.largest, pairs = (tri, q), n

        def timed(tri, resp, q, *args, **kw):
            sync(q.device)
            t0 = time.perf_counter()
            out = self._orig(tri, resp, q, *args, **kw)
            sync(q.device)
            t1 = time.perf_counter()
            self.rounds.append({"dropped": int(q.shape[0]), "n_tris": int(tri.n_tris),
                                "build_s": t0 - self._last, "interp_s": t1 - t0})
            keep(tri, q)
            self._last = t1
            return out

        device_tri.interp = timed
        return self

    def __exit__(self, *exc):
        from gsl_scattered_interpolation_torch.models import device_tri

        device_tri.interp = self._orig
        return False


def thin_200k(rec, device="cuda"):
    """thin() of 200,000 sites to tol 1e-3: the device builder in float32
    (each round's build launches the candidate kernel; its evaluation
    launches the locate kernel while T <= PALLAS_LOCATE_MAX_TRIS), then
    the Qhull builder in float64; each held by scipy on the kept sites."""
    import torch

    from gsl_scattered_interpolation_torch.models import device_tri, thinning

    rng = np.random.default_rng(45)
    sites = rng.uniform(-1.0, 1.0, size=(N_THIN, 2))
    vals = np.sin(3 * sites[:, 0]) * np.cos(2 * sites[:, 1])
    for builder, dtype in (("device", torch.float32), ("qhull", torch.float64)):
        name = str(dtype).split(".")[-1]
        r = {}
        before = dict(rec.get("main_launches", dict.fromkeys(_counted(), 0)))
        before_k = dict(rec.get("main_kernels", dict.fromkeys(_kernel_counts(_counted()), 0)))
        with RoundClock() as clock:
            res, r["thin_s"] = _main_run(rec, lambda: _timed(lambda: thinning.thin(
                sites, vals, THIN_TOL, builder=builder, dtype=dtype, device=device), device))
        r.update(rounds=res.rounds, kept=int(res.keep.size), max_error=res.max_error,
                 locate2d_launches=rec["main_launches"]["locate2d"] - before["locate2d"],
                 locate2d_kernels=rec["main_kernels"]["locate2d"] - before_k["locate2d"],
                 candmath2d_launches=rec["main_launches"]["candmath2d"] - before["candmath2d"],
                 per_round=clock.rounds)
        require(res.max_error <= THIN_TOL, f"thin {builder}: {r}")
        r["scipy_max_miss"] = _thin_contract(res, sites, vals, builder == "device")
        require(r["scipy_max_miss"] <= THIN_TOL + THIN_SLACK[name], f"thin {builder} contract: {r}")
        if builder == "device":
            require(r["candmath2d_launches"] > 0 and r["locate2d_launches"] > 0,
                    f"thin device: a kernel never launched: {r}")
            # The locate kernel at the largest (B, T) of the f32 rounds.
            r["kernel"] = check_locate(*clock.largest)
        drop = np.setdiff1d(np.arange(N_THIN), res.keep)
        q = torch.tensor(sites[drop], dtype=dtype, device=device)
        resp = device_tri.response_for_build(res.shuffle, vals[res.keep], device=device).to(dtype)
        busy, wall, _ = profile_build(lambda: device_tri.interp(res.tri, resp, q))
        r["profiled_last_interp"] = {"wall_s": wall / 1e3, "device_busy_ms": busy,
                                     "device_idle_share": 1.0 - busy / wall}
        rec[f"{builder}_{name}"] = r


def alpha_ball_61k(rec, device="cuda"):
    """reconstruct_surface of a solid ball on a jittered grid of 49 nodes
    per axis (tests/test_surface.py:27-38 at 61,600 points): watertight,
    Euler characteristic 2, boundary on the sphere."""
    from scipy.spatial import Delaunay

    from gsl_scattered_interpolation_torch.models import geometry_extras as gx
    from gsl_scattered_interpolation_torch.models import surface

    rng = np.random.default_rng(0)
    g = np.linspace(-1, 1, ALPHA_AXIS)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[np.linalg.norm(pts, axis=1) <= 1.0]
    h = g[1] - g[0]
    pts = pts + rng.uniform(-0.05 * h, 0.05 * h, pts.shape)
    rec["points"] = int(pts.shape[0])
    (faces, alpha), rec["reconstruct_s"] = _main_run(rec, lambda: _timed(
        lambda: surface.reconstruct_surface(pts, alpha=1.2 * h, device=device), device))
    t0 = time.perf_counter()
    sd = Delaunay(pts)
    rec["qhull_s"] = time.perf_counter() - t0
    tri, rec["import_s"] = _timed(lambda: gx.from_scipy_delaunay(sd, pts, device=device), device)
    shape, rec["alpha_shape_s"] = _timed(lambda: surface.alpha_shape(tri, alpha), device)
    busy, wall, _ = profile_build(lambda: surface.alpha_shape(tri, alpha))
    rec["profiled_alpha_shape"] = {"wall_s": wall / 1e3, "device_busy_ms": busy,
                                   "device_idle_share": 1.0 - busy / wall}
    require(np.array_equal(shape.faces, faces), "alpha_shape differs from reconstruct_surface")
    rec["tets"], rec["faces"] = int(tri.n_tris), int(faces.shape[0])
    require(surface.edge_manifold_check(faces), "alpha ball surface is not 2-manifold")
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [0, 2]]], 0)
    V, E, F = np.unique(faces).size, np.unique(np.sort(e, 1), axis=0).shape[0], faces.shape[0]
    rec["euler"] = int(V - E + F)
    require(rec["euler"] == 2, f"Euler characteristic {rec['euler']}")
    rad = np.linalg.norm(pts[np.unique(faces)], axis=1)
    rec["boundary_radius_min"] = float(rad.min())
    require(rec["boundary_radius_min"] > 1.0 - 2.5 * h, f"alpha ball radius: {rec}")


def phase_structured(device="cuda"):
    """The structured phase: each configuration counted from zero.  Every
    tridiagonal system the main path solved is held against the plain
    version of its route on the card, both routes timed.  Returns {name:
    record}."""
    out = {}
    for name, body in (("gsl_golden", gsl_golden), ("gsl1d_1m", gsl1d_1m),
                       ("gsl2d_2k", gsl2d_2k), ("boundary_100k", boundary_100k),
                       ("geometry_200k", geometry_200k), ("thin_200k", thin_200k),
                       ("alpha_ball_61k", alpha_ball_61k)):
        out[name] = _config(name, device, functools.partial(body, device=device))
    require(out["gsl1d_1m"]["cspline"]["tridiag_solves"] == 1
            and out["gsl1d_1m"]["cspline_periodic"]["tridiag_solves"] == 1,
            "a gsl1d spline init did not solve once")
    require(out["gsl2d_2k"]["bicubic"]["tridiag_solves"] == 3,
            "the bicubic init did not solve three times")
    # cspline 1, cspline_periodic 1, bicubic 3 on the golden file's knots.
    require(out["gsl_golden"]["tridiag_solves"] == 5,
            f"gsl_golden: {out['gsl_golden']['tridiag_solves']} tridiagonal solves")
    require(out["boundary_100k"]["kernel_launches"] == 1, "boundary: locate2d launches")
    return out


def tridiag_summary(pcfg):
    """The two tridiagonal records of the kernels line, one per route, each
    with every system the structured phase solved (gsl_golden's five, the
    two 10^6-row splines, the three bicubic derivative grids) under
    ``systems`` and both routes side by side on each under ``routes``.
    Each route is headlined at a system its main path gave it: the
    partitioned one at the cspline system (n = 999,998, m = 1, float64),
    the sequential one at gsl_golden's largest (the 10^6-row and grid
    systems, which the main path sends to the partitioned route, keep the
    sequential route's times under ``routes`` as the comparison)."""
    one_d = [pcfg["gsl1d_1m"][k]["tridiag_kernel"] for k in ("cspline", "cspline_periodic")]
    golden = pcfg["gsl_golden"]["tridiag_kernel"]
    systems = golden + one_d + pcfg["gsl2d_2k"]["tridiag_kernel"]
    seq_main = max((r for r in systems if r["route"] == "sequential"),
                   key=lambda r: r["n"] * r["m"])
    routes = {
        route: [{"system": r["system"], "main_path": r["route"] == route,
                 "bound_ms": r["bound_ms"],
                 **{k: r[route][k] for k in ("ms", "device_ms", "plain_ms", "mismatches",
                                              "traffic_ms") if k in r[route]}}
                for r in systems]
        for route in ("partitioned", "sequential")}
    by_path = {k: {"tridiag": r["tridiag_launches"],
                   "tridiag_partitioned": r["tridiag_partitioned_launches"]}
               for k, r in pcfg.items()}
    checked = [r[route] for r in systems for route in ("partitioned", "sequential")
               if "mismatches" in r[route]]
    common = {
        "route": "cuda",
        "source": "gsl_scattered_interpolation_torch/kernels/csrc/tridiag.cu",
        # Not a Pallas kernel: JAX's lax.scan Thomas sweeps.
        "replaces": "gsl_scattered_interpolation_tpu/ops/tridiag.py:16",
        "max_abs_err": max(r["max_abs_err"] for r in checked),
        "mismatches": sum(r["mismatches"] for r in checked),
        # Solves (wrapper calls) per configuration's main-path runs; the
        # CUDA kernels per solve are in each system's kernels_per_solve.
        "launches_by_path": by_path,
        "routes": routes,
        "systems": systems,
    }

    def headline(name, r, route, launches):
        return {"name": name, **common, "launches": launches,
                "shape": f"n={r['n']} m={r['m']} {r['dtype']}",
                **{k: r[route][k] for k in ("ms", "device_ms", "plain_ms") if k in r[route]},
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                # torch.linalg.solve on the dense matrix at the golden
                # systems; none at the 10^6-row systems, whose dense matrix
                # would take 8 TB.
                "library_ms": r.get("library_ms"),
                "library_max_rel_err": r.get("library_max_rel_err")}

    return [headline("tridiag", seq_main, "sequential",
                     sum(v["tridiag"] for v in by_path.values())),
            headline("tridiag_partitioned", one_d[0], "partitioned",
                     sum(v["tridiag_partitioned"] for v in by_path.values()))]


# The parallel phase: the port's parallel/ on torch.distributed, at world
# size 1 under NCCL (as run with no arguments: one card), in a fresh process
# that keeps NCCL's state out of the other phases.  World size 1 cuts nothing
# but the ranks: each configuration runs at its single-process size.
# ``--parallel-ranks N ...`` runs the same configurations at N ranks, one
# card each, every rank's part held against the single-process function.
PARALLEL_TIMEOUT_S = 240
PARALLEL_RANKS_TIMEOUT_S = 600
# tp_cg's 8,192 = N_DIRECT sites lie on a jittered lattice at the density of
# the JAX package's sharded-CG test.  On uniform random sites plain CG (JAX's
# algorithm) does not reach tol 1e-10 within 500 iterations: the phase reads
# that on rbf_direct's sites and on uniform sites at the lattice's density.
TP_CG_LATTICE = (128, 64)
TP_CG_NEIGHBORS = 33       # sites within each one's support: JAX's test's density
TP_CG_EPS = 6.0
TP_CG_MAXITER = 500
TP_CG_VS_DIRECT_MAX = 1e-6    # tests/test_parallel.py's tolerance
RING_MAXITER = 100            # a depth cut, for time (wendland_1m's PCG runs 400)
RING_MATVEC_REL_MAX = 1e-6
RING_FIT_REL_MAX = 1e-4
CHOL_BLOCK = 256
CHOL_VS_LIBRARY_MAX = 1e-8    # times n: tests/test_parallel.py's tolerance
CHOL_SOLVE_MAX = 1e-7


def _mismatches(outs, refs):
    """Entries of the outputs that are not bit-equal to the references."""
    return sum(int((a != b).sum()) for a, b in zip(outs, refs))


def _world() -> int:
    import torch

    return torch.distributed.get_world_size()


def _rank_rows(n, mesh, axis):
    """This rank's rows of ``n`` along the mesh's ``axis``."""
    from gsl_scattered_interpolation_torch.parallel import sharding

    return sharding._block(n, mesh, axis, "chip_smoke")


def par_dp_interp(rec, device="cuda"):
    """The headline (2,000 sites, T = 4,001, the host build in float32)
    under 10 batches of 10^6 queries through ``interp_sharded`` over every
    rank as ``dp``: the locate kernel's route, one wrapper call per batch;
    each rank's block bit-equal to ``device_tri.interp`` on the same rows,
    and the gathered first batch to ``interp`` on the whole batch."""
    import torch

    from gsl_scattered_interpolation_torch.models import device_tri, host_tree
    from gsl_scattered_interpolation_torch.parallel import mesh as pmesh, sharding

    sites, values = headline_problem(N_SITES, 0)
    tree = host_tree.build(sites, flags=host_tree.NOSTANDARDIZE)
    tri = device_tri.freeze(tree, grid_res=128, device=device).cast(torch.float32)
    resp = device_tri.reindex_response(tree, values, device=device).to(torch.float32)
    mesh = pmesh.make_mesh(dp=_world(), tp=1, device=device)
    rows = _rank_rows(BATCH, mesh, "dp")
    block = rows.stop - rows.start
    Q = uniform_queries(BATCH, seed=1, device=device, batches=N_BATCHES)
    sharding.interp_sharded(tri, resp, Q[0], mesh)  # first use loads the kernel
    outs, rec["eval_s"] = _timed(lambda: _main_run(rec, lambda: [
        sharding.interp_sharded(tri, resp, Q[i], mesh) for i in range(N_BATCHES)]), device)
    # queries_per_s is this rank's.
    rec.update(T=tri.n_tris, B=BATCH, block=block, batches=N_BATCHES,
               mesh=list(mesh.shape), queries_per_s=block * N_BATCHES / rec["eval_s"])
    rec["mismatches"] = _mismatches(outs, [device_tri.interp(tri, resp, Q[i][rows])
                                           for i in range(N_BATCHES)])
    rec["gathered_mismatches"] = _mismatches([sharding.gather_rows(outs[0], mesh)],
                                             [device_tri.interp(tri, resp, Q[0])])
    require(all(o.shape == (block,) and bool(torch.isfinite(o).all()) for o in outs),
            "dp_interp: wrong shape or non-finite values")
    require(rec["mismatches"] == 0 and rec["gathered_mismatches"] == 0,
            f"dp_interp differs from interp: {rec}")
    require(rec["main_launches"]["locate2d"] == N_BATCHES,
            f"dp_interp: {rec['main_launches']['locate2d']} locate2d calls")


def par_dp_cells(rec, device="cuda"):
    """The 200k float32 device build of BUILD_SEED (T = 400,001) with its
    cell index, one 10^6-query batch through ``interp_sharded(method=
    "cells")`` over every rank as ``dp``, each rank's block bit-equal to
    the single-process call on the same rows."""
    import torch

    from gsl_scattered_interpolation_torch import ScatteredInterp
    from gsl_scattered_interpolation_torch.models import device_tri
    from gsl_scattered_interpolation_torch.models.scattered import NOSTANDARDIZE
    from gsl_scattered_interpolation_torch.parallel import mesh as pmesh, sharding

    sites = np.random.default_rng(BUILD_SEED).uniform(-0.5, 0.5, size=(N_BUILD, 2))
    si, rec["build_s"] = _timed(lambda: ScatteredInterp(
        sites, headline_values(sites), flags=NOSTANDARDIZE, engine="device",
        dtype=torch.float32, grid_res=256, device=device), device)
    cells, rec["index_s"] = _timed(si._get_cells, device)
    q = uniform_queries(BATCH, seed=5, device=device)[0]
    mesh = pmesh.make_mesh(dp=_world(), tp=1, device=device)
    rows = _rank_rows(BATCH, mesh, "dp")
    block = rows.stop - rows.start
    si.eval(q)  # first use of the cell route in this process
    out, rec["eval_s"] = _timed(lambda: _main_run(rec, lambda: sharding.interp_sharded(
        si.tri, si.response, q, mesh, method="cells", cells=cells)), device)
    rec.update(T=si.n_simplexes, B=BATCH, block=block, queries_per_s=block / rec["eval_s"],
               mismatches=_mismatches([out], [device_tri.interp(
                   si.tri, si.response, q[rows], method="cells", cells=cells)]))
    require(out.shape == (block,) and bool(torch.isfinite(out).all()),
            "dp_cells: wrong shape or non-finite values")
    require(rec["mismatches"] == 0, f"dp_cells differs from interp: {rec}")


def tp_cg_problem():
    """8,192 sites on a jittered 128 x 64 lattice whose spacing puts about
    TP_CG_NEIGHBORS sites within each one's support (1/TP_CG_EPS), and
    bench.py's test function."""
    h = np.sqrt(np.pi / TP_CG_NEIGHBORS) / TP_CG_EPS
    ij = np.stack(np.meshgrid(*map(np.arange, TP_CG_LATTICE), indexing="ij"), -1)
    lattice = ij.reshape(-1, 2) * h
    sites = lattice + np.random.default_rng(33).uniform(-0.3 * h, 0.3 * h, lattice.shape)
    return sites, headline_values(sites)


def tp_cg_uniform_problems():
    """{name: (sites, values)} of N_DIRECT uniform random sites: rbf_direct's
    (default_rng(31) in [-1, 1]^2, about 180 sites within each support) and
    sites over the lattice's extent (about TP_CG_NEIGHBORS within each)."""
    h = np.sqrt(np.pi / TP_CG_NEIGHBORS) / TP_CG_EPS
    direct = np.random.default_rng(31).uniform(-1.0, 1.0, size=(N_DIRECT, 2))
    extent = np.random.default_rng(34).uniform(
        0.0, np.array(TP_CG_LATTICE, dtype=float) * h, size=(N_DIRECT, 2))
    return {name: (s, headline_values(s))
            for name, s in (("uniform_rbf_direct", direct), ("uniform_lattice_extent", extent))}


def _tp_cg_fit(rec, sites, values, mesh, device, main):
    """``rbf_fit_cg_sharded`` (tol 1e-10, TP_CG_MAXITER) beside the port's
    direct ``RbfInterp`` (Cholesky) of the same Wendland-C2 system, into
    ``rec``; the fit counted as the main path where ``main``."""
    import torch

    from gsl_scattered_interpolation_torch.models import rbf
    from gsl_scattered_interpolation_torch.parallel import sharding

    direct, rec["direct_s"] = _timed(lambda: rbf.RbfInterp(
        sites, values, kernel="wendland_c2", epsilon=TP_CG_EPS, standardize=False,
        dtype=torch.float64, device=device), device)
    require(direct.solver == "direct", f"RbfInterp took {direct.solver}")
    stats = {}

    def fit():
        return sharding.rbf_fit_cg_sharded(sites, values, mesh, epsilon=TP_CG_EPS,
                                           tol=1e-10, maxiter=TP_CG_MAXITER, stats=stats)

    lam, rec["fit_s"] = _timed((lambda: _main_run(rec, fit)) if main else fit, device)
    rec.update(n=sites.shape[0], **stats,
               rel_residual=stats["residual"] / float(np.linalg.norm(values)),
               s_per_iteration=rec["fit_s"] / max(stats["iterations"], 1),
               max_abs_vs_direct=float((lam - direct.lam).abs().max()),
               max_abs_lam=float(direct.lam.abs().max()))


def par_tp_cg(rec, device="cuda"):
    """``rbf_fit_cg_sharded`` of Wendland-C2 over N_DIRECT lattice sites in
    float64, every rank as ``tp``, within TP_CG_VS_DIRECT_MAX of the direct
    solve; then the same fit on the uniform sites of
    :func:`tp_cg_uniform_problems`, read and not gated."""
    from gsl_scattered_interpolation_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(dp=1, tp=_world(), device=device)
    sites, values = tp_cg_problem()
    _tp_cg_fit(rec, sites, values, mesh, device, main=True)
    for name, (s, v) in tp_cg_uniform_problems().items():
        _tp_cg_fit(rec.setdefault(name, {}), s, v, mesh, device, main=False)
    require(rec["max_abs_vs_direct"] < TP_CG_VS_DIRECT_MAX, f"tp_cg against direct: {rec}")


def par_sp_ring(rec, device="cuda"):
    """The cell grid that CompactRbf builds for wendland_1m (1,000,000
    sites of default_rng(4), its default epsilon, float32), its rows padded
    to the ranks, on the sp ring: ``fit_cg_ring`` and the single-process
    ``_cg_pad`` at tol 1e-6 and RING_MAXITER, its dot products summed over
    the ranks' row blocks in rank order as the ring sums them, then one
    ``matvec_ring`` on this rank's rows against ``matvec_pad``'s."""
    import torch

    from gsl_scattered_interpolation_torch.models import rbf, rbf_compact
    from gsl_scattered_interpolation_torch.parallel import mesh as pmesh, ring

    rng = np.random.default_rng(4)
    sites = rng.uniform(-1.0, 1.0, size=(N_WENDLAND, 2))
    values = np.sin(3 * sites[:, 0]) * np.cos(2 * sites[:, 1])
    shift, scale = rbf.standardization(sites)
    eps = 1.0 / float(np.sqrt(40.0 / (np.pi * N_WENDLAND)))  # CompactRbf's default
    grid, rec["grid_s"] = _timed(lambda: ring.pad_grid_rows(rbf_compact.build_cell_grid(
        scale * (sites - shift), 1.0 / eps, device=device, dtype=torch.float32), _world()),
        device)
    y_pad = rbf_compact.pack_values(grid, torch.tensor(values, dtype=torch.float32,
                                                       device=device))
    mesh = pmesh.make_ring_mesh(device)
    rows = _rank_rows(grid.xs_pad.shape[0], mesh, "sp")
    phi = rbf.KERNELS["wendland_c2"].phi
    (lam, res, its), rec["fit_s"] = _timed(lambda: _main_run(rec, lambda: ring.fit_cg_ring(
        grid, y_pad, mesh, epsilon=eps, tol=1e-6, maxiter=RING_MAXITER)), device)
    (ref, rs, it), rec["fit_pad_s"] = _timed(lambda: rbf_compact._cg_pad(
        grid, phi, eps, 0.0, y_pad, 1e-6, RING_MAXITER, blocks=_world()), device)
    rec["lam_mismatches"] = _mismatches([lam], [ref])
    if _world() > 1:
        # The plain _cg_pad sums each dot product at once: another order,
        # which 100 float32 iterations short of tol amplify.  Read only.
        plain = rbf_compact._cg_pad(grid, phi, eps, 0.0, y_pad, 1e-6, RING_MAXITER)[0]
        rec["lam_vs_plain_cg_pad_rel"] = float((lam - plain).abs().max() / plain.abs().max())
    got, rec["matvec_s"] = _timed(lambda: ring.matvec_ring(
        grid.xs_pad[rows], y_pad[rows], phi, eps, 0.0, mesh.get_group("sp")), device)
    want, rec["matvec_pad_s"] = _timed(
        lambda: rbf_compact.matvec_pad(grid, phi, eps, 0.0, y_pad), device)
    want = want[rows]
    rec["matvec_max_rel_err"] = float((got - want).abs().max() / want.abs().max())
    rec.update(grid=list(grid.shape), rows=rows.stop - rows.start, cap=grid.cap,
               epsilon=eps, iterations=its, iterations_pad=int(it),
               rel_residual=res / float(np.linalg.norm(values)),
               s_per_iteration=rec["fit_s"] / max(its, 1),
               pad_s_per_iteration=rec["fit_pad_s"] / max(int(it), 1),
               lam_max_rel_err=float((lam - ref).abs().max() / ref.abs().max()))
    require(rec["matvec_max_rel_err"] < RING_MATVEC_REL_MAX, f"matvec_ring: {rec}")
    require(its == int(it), f"fit_cg_ring took {its} iterations, _cg_pad {int(it)}")
    require(rec["lam_max_rel_err"] < RING_FIT_REL_MAX, f"fit_cg_ring: {rec}")


def par_tp_cholesky(rec, device="cuda"):
    """``cholesky_sharded`` of A = B B^T + n I (n = N_DIRECT, float64,
    block CHOL_BLOCK), every rank as ``tp``, this rank's rows against
    ``torch.linalg.cholesky``'s, both timed, and the solve's round trip."""
    import torch

    from gsl_scattered_interpolation_torch.parallel import cholesky, mesh as pmesh

    n = N_DIRECT
    gen = torch.Generator(device=device).manual_seed(35)
    B = torch.randn(n, n, generator=gen, dtype=torch.float64, device=device)
    A = B @ B.T + n * torch.eye(n, dtype=torch.float64, device=device)
    del B
    x_true = torch.randn(n, generator=gen, dtype=torch.float64, device=device)
    mesh = pmesh.make_mesh(dp=1, tp=_world(), device=device)
    rows = _rank_rows(n, mesh, "tp")
    small = A[:CHOL_BLOCK * 2, :CHOL_BLOCK * 2]  # first use of the solver libraries
    cholesky.cholesky_sharded(small, mesh, block=CHOL_BLOCK)
    torch.linalg.cholesky(small)
    L, rec["s"] = _timed(lambda: _main_run(rec, lambda: cholesky.cholesky_sharded(
        A, mesh, block=CHOL_BLOCK)), device)
    L_lib, rec["library_s"] = _timed(lambda: torch.linalg.cholesky(A), device)
    x, rec["solve_s"] = _timed(
        lambda: cholesky.cholesky_solve_sharded(L, A @ x_true, mesh), device)
    rec.update(n=n, block=CHOL_BLOCK, rows=rows.stop - rows.start,
               max_abs_vs_library=float((L - L_lib[rows]).abs().max()),
               solve_max_err=float((x - x_true).abs().max()))
    require(rec["max_abs_vs_library"] < CHOL_VS_LIBRARY_MAX * n, f"tp_cholesky: {rec}")
    require(rec["solve_max_err"] < CHOL_SOLVE_MAX, f"tp_cholesky solve: {rec}")


def par_dryrun(rec, device="cuda"):
    """``dryrun_multichip`` on this rank."""
    from gsl_scattered_interpolation_torch.parallel import dryrun

    rec.update(dryrun.dryrun_multichip(_world(), device))


PARALLEL_CONFIGS = (("dp_interp", par_dp_interp), ("dp_cells", par_dp_cells),
                    ("tp_cg", par_tp_cg), ("sp_ring", par_sp_ring),
                    ("tp_cholesky", par_tp_cholesky), ("dryrun", par_dryrun))


def phase_parallel_rank(device="cuda", keep_going=False):
    """Every parallel configuration on the rank of a group that the caller
    joined, each counted from zero.  Returns {name: record}.  A failed
    check raises; with ``keep_going`` it is written to the record as
    ``failed`` and the next configuration runs (every check follows its
    configuration's last collective, so the ranks stay in step)."""
    import torch

    require(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are on")
    out = {}
    for name, body in PARALLEL_CONFIGS:
        try:
            out[name] = _config(name, device, functools.partial(body, device=device))
        except AssertionError as e:
            if not keep_going:
                raise
            out[name] = {"failed": str(e)}
            log(f"{name} FAILED: {e}")
    return out


def parallel_main() -> int:
    """In a fresh process: join a group of one rank under NCCL, run
    :func:`phase_parallel_rank`, print its records as one JSON line."""
    import torch

    from gsl_scattered_interpolation_torch.parallel import launch

    t0 = time.perf_counter()
    launch.init_group(0, 1, device="cuda")
    try:
        out = {"backend": torch.distributed.get_backend(),
               "world_size": torch.distributed.get_world_size(),
               "configs": phase_parallel_rank()}
    finally:
        torch.distributed.destroy_process_group()
    out["process_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


def phase_parallel():
    """:func:`parallel_main` in a fresh process; its log lines are shown
    here, and a failure there fails this script.  Returns its record."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.parallel_main())"],
        capture_output=True, text=True, timeout=PARALLEL_TIMEOUT_S, cwd=here,
        env={**os.environ, "PYTHONPATH": here})
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"parallel | {line}")
    require(out.returncode == 0 and bool(lines),
            f"the parallel phase failed (exit {out.returncode}):\n{out.stderr[-4000:]}")
    return json.loads(lines[-1])


def parallel_ranks_main(worlds, out_path=None) -> int:
    """``--parallel-ranks N ...``: for each N, every parallel configuration
    at N ranks under NCCL, one card each (``launch.spawn``), each rank's
    part held against the single-process function as at one rank.  Prints
    a line for each rank's configurations, and writes every record to
    ``out_path`` where given."""
    import torch

    from gsl_scattered_interpolation_torch.kernels import build
    from gsl_scattered_interpolation_torch.ops import locate
    from gsl_scattered_interpolation_torch.parallel import launch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    build.build(locate.KERNEL)  # once, before the ranks load it
    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    runs = {}
    for world in worlds:
        t0 = time.perf_counter()
        ranks = launch.spawn(phase_parallel_rank, world, "cuda", "cuda", True,
                             timeout=PARALLEL_RANKS_TIMEOUT_S)
        runs[world] = {"spawn_s": time.perf_counter() - t0, "ranks": ranks}
        for r, configs in enumerate(ranks):
            log(f"parallel at {world} ranks, rank {r}: " + json.dumps(
                {k: {f: v for f, v in c.items() if not isinstance(v, (dict, list))}
                 for k, c in configs.items()}))
        failed = sorted({k for c in ranks for k, rec in c.items() if "failed" in rec})
        log(f"parallel at {world} ranks: {runs[world]['spawn_s']:.2f} s, "
            + (f"FAILED: {failed}" if failed else "every check passed"))
    if out_path:
        with open(out_path, "w") as f:
            json.dump(runs, f, indent=1)
    return int(any("failed" in rec for run in runs.values()
                   for c in run["ranks"] for rec in c.values()))


def main() -> int:
    t_all = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    from gsl_scattered_interpolation_torch.kernels import build
    from gsl_scattered_interpolation_torch.ops import candmath, cells, locate, tridiag, walk

    # 1. Device.
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    log(f"phase device: {time.perf_counter() - t0:.2f} s")

    # 2. Build every kernel of the paths from the sources, one nvcc each,
    # all started together.
    def timed_build(name):
        t0 = time.perf_counter()
        return build.build(name).strip(), time.perf_counter() - t0

    names = (locate.KERNEL, candmath.KERNEL, tridiag.KERNEL, cells.KERNEL, walk.KERNEL)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(timed_build, names)))
    for name, (out, secs) in built.items():
        log(f"nvcc {name}: {secs:.2f} s\n{out}")

    loc_sass = locate_sass()
    sass = sass_counts(candmath.KERNEL)
    require(set(sass) == {"float", "double"}, f"SASS functions: {sorted(sass)}")
    for fn, ops in sass.items():
        pre = fn[0].upper()  # FADD, FMUL, FSETP, ... or DADD, DMUL, DSETP, ...
        fp = sum(n for op, n in ops.items() if op[0] == pre)
        log(f"sass {candmath.KERNEL}<{fn}>: {sum(ops.values())} instructions, "
            f"{fp} of them {pre}*; {json.dumps(ops)}")

    # 3. Locate kernel against its plain version at T = 4001 and T = 16001.
    global LOCATE_CALLS
    LOCATE_CALLS = LocateCalls()
    t0 = time.perf_counter()
    locate_recs = []
    locate_tris = (host_triangulation(N_SITES, 0, "cuda"),
                   device_triangulation(N_SITES_LARGE, 1, "cuda"))
    for tri in locate_tris:
        q = uniform_queries(BATCH, seed=2, device="cuda")[0]
        locate_recs.append(check_locate(tri, q))
    torch.cuda.synchronize()
    log(f"phase locate kernel-vs-plain: {time.perf_counter() - t0:.2f} s")

    # 4. Candidate kernel against its plain version at three build states.
    t0 = time.perf_counter()
    build_sites = np.random.default_rng(BUILD_SEED).uniform(-0.5, 0.5, size=(N_BUILD, 2))
    cand_recs = {}
    for dtype in (torch.float32, torch.float64):
        cand_recs[dtype] = check_candmath(build_sites, dtype, "cuda")
    log(f"phase candmath kernel-vs-plain: {time.perf_counter() - t0:.2f} s")

    # 5. The device build at scale, float32 then float64.
    t0 = time.perf_counter()
    (b32, _), (b64, scipy64) = (
        build_at_scale(build_sites, dt, "cuda")
        for dt in (torch.float32, torch.float64)
    )
    log(f"phase device build at scale: {time.perf_counter() - t0:.2f} s")

    # 6. The main paths, each counted from zero.
    t0 = time.perf_counter()
    _zero_counts({"locate2d": locate.locate2d_cuda})
    host = main_path("cuda", N_SITES, BATCH, N_BATCHES, N_CHECK, "host")
    host["locate2d_launches"] = locate.locate2d_cuda.launches
    host["locate2d_kernels"] = locate.locate2d_cuda.kernel_launches
    log(f"main path: {json.dumps(host)}")
    require(host["locate2d_launches"] > 0, "the host path never launched locate2d")
    log(f"phase main path host: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    _zero_counts({"locate2d": locate.locate2d_cuda,
                  "candmath2d": candmath.edge_candidates_math_cuda})
    dev = main_path("cuda", N_SITES, BATCH, N_BATCHES, N_CHECK, "device")
    dev["locate2d_launches"] = locate.locate2d_cuda.launches
    dev["locate2d_kernels"] = locate.locate2d_cuda.kernel_launches
    dev["candmath2d_launches"] = candmath.edge_candidates_math_cuda.launches
    log(f"main path: {json.dumps(dev)}")
    require(dev["locate2d_launches"] > 0, "the device path never launched locate2d")
    require(dev["candmath2d_launches"] > 0, "the device path never launched candmath2d")
    log(f"phase main path device: {time.perf_counter() - t0:.2f} s")

    # 7. The at-scale query path: the 200k sites (T = 400,001) in float32
    # and float64, and 20,000 sites (T = 40,001), each with the index that
    # build_cell_index(method="auto") picks; then the crossover of the
    # kernel, the index and the walk, and of the index's two builds.
    t0 = time.perf_counter()
    at_scale, facades = {}, {}
    at_scale["f32_200k"], facades["f32_200k"] = at_scale_query(
        build_sites, torch.float32, N_BATCHES)
    at_scale["f64_200k"], _ = at_scale_query(
        build_sites, torch.float64, 1, scipy_tri=scipy64)
    small_sites = np.random.default_rng(BUILD_SEED + 1).uniform(
        -0.5, 0.5, size=(N_SCALE_SMALL, 2))
    at_scale["f32_20k"], facades["f32_20k"] = at_scale_query(
        small_sites, torch.float32, 1)
    log(f"phase at-scale query: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    cases = [(tri, torch.ones(tri.points_raw.shape[0], device="cuda"), None)
             for tri in locate_tris]
    cases += [(f.tri, f.response, f._cells)
              for f in (facades["f32_20k"], facades["f32_200k"])]
    cross = crossover(cases)
    log(f"phase crossover: {time.perf_counter() - t0:.2f} s")

    # 8. The build at 1M: the candidate kernel on the compacted rows, then
    # the facade in float32 and float64, each counted from zero.
    t0 = time.perf_counter()
    compact_recs, b1m = phase_1m()
    log(f"phase build at 1M: {time.perf_counter() - t0:.2f} s")

    # 9. The 3D phase: the cavity builds at 10k and 100k and the 3D cell
    # index at 2M queries per batch, each path counted from zero (neither
    # kernel is on it).
    t0 = time.perf_counter()
    p3d = phase_3d()
    log(f"phase 3D: {time.perf_counter() - t0:.2f} s")

    # 10. The RBF phase: bench.py's tps_100k, wendland_1m, weights and
    # kriging_100k, and the direct and pcg thin-plate solvers, each counted
    # from zero (neither kernel is on it).
    t0 = time.perf_counter()
    prbf = phase_rbf()
    log(f"phase RBF: {time.perf_counter() - t0:.2f} s")

    # 11. The structured phase: the GSL 1D and 2D family through both
    # tridiagonal routes, the locate kernel's boundary check at T ~ 101,000,
    # and the geometry consumers (hull, Voronoi, serialize, thinning, alpha
    # shapes), each counted from zero.
    t0 = time.perf_counter()
    pcfg = phase_structured()
    log(f"phase structured: {time.perf_counter() - t0:.2f} s")

    # 12. One call of each locate route at each checked shape, counted and
    # profiled in a fresh process.
    t0 = time.perf_counter()
    LOCATE_CALLS.profile()
    bnd = pcfg["boundary_100k"]
    require(bnd["cuda_kernels"] == bnd["kernel"]["leaf_call"]["kernels_per_call"],
            f"boundary: {bnd['cuda_kernels']} CUDA kernels on the main path, "
            f"{bnd['kernel']['leaf_call']['kernels_per_call']} in the profiled call")
    log(f"phase locate calls profiled: {time.perf_counter() - t0:.2f} s")

    # 13. The parallel phase: parallel/ at world size 1 under NCCL, in a
    # fresh process, each configuration counted from zero.
    t0 = time.perf_counter()
    ppar = phase_parallel()
    pcfgs = ppar["configs"]
    pcfgs["dp_interp"]["headline_queries_per_s"] = host["queries_per_s"]
    require(pcfgs["dp_interp"]["locate2d_kernels"] == host["locate2d_kernels"],
            f"dp_interp launched {pcfgs['dp_interp']['locate2d_kernels']} CUDA kernels, "
            f"the headline's host path {host['locate2d_kernels']}")
    log(f"phase parallel: {time.perf_counter() - t0:.2f} s")

    TIMES = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")
    loc = locate_recs[0]
    loc_shapes = {"headline": loc, "t16001": locate_recs[1],
                  "boundary_100k": pcfg["boundary_100k"]["kernel"],
                  "thin_200k": pcfg["thin_200k"]["device_float32"]["kernel"]}
    c32 = cand_recs[torch.float32][-1]
    c64 = cand_recs[torch.float64][-1]
    c2d = b1m["f32"]["cells2d"]
    w2d = b1m["f32"]["walk2d"]
    kernels = [{
        "name": locate.KERNEL,
        "route": "cuda",
        "source": "gsl_scattered_interpolation_torch/kernels/csrc/locate2d.cu",
        "replaces": "gsl_scattered_interpolation_tpu/ops/pallas_locate.py:35",
        "launches": dev["locate2d_launches"],
        # CUDA kernels on the main paths, by the wrapper's counter (the
        # sweep, and the merge pass where the call splits); each shape's
        # record holds one call's count beside what the profiler saw.
        "cuda_kernels": dev["locate2d_kernels"],
        "cuda_kernels_by_path": {"host": host["locate2d_kernels"],
                                 "device": dev["locate2d_kernels"],
                                 **{k: r["locate2d_kernels"] for k, r in pcfg.items()},
                                 **{f"parallel_{k}": r["locate2d_kernels"]
                                    for k, r in pcfgs.items()}},
        "launches_by_path": {"host": host["locate2d_launches"],
                             "device": dev["locate2d_launches"],
                             **{f"at_scale_{k}": r["locate2d_launches"]
                                for k, r in at_scale.items()},
                             **{f"build_1m_{k}": r["locate2d_launches"]
                                for k, r in b1m.items()},
                             **{k: r["locate2d_launches"] for k, r in p3d.items()},
                             **{k: r["locate2d_launches"] for k, r in prbf.items()},
                             **{k: r["locate2d_launches"] for k, r in pcfg.items()},
                             **{f"parallel_{k}": r["locate2d_launches"]
                                for k, r in pcfgs.items()}},
        "max_abs_err": max(r["max_abs_err"] for r in loc_shapes.values()),
        "weights_max_abs_err": max(r["weights_max_abs_err"] for r in loc_shapes.values()),
        "ms": loc["ms"],
        "device_ms": loc["device_ms"],
        "plain_ms": loc["plain_ms"],
        "bound_ms": loc["bound_ms"],
        "bound_by": loc["bound_by"],
        "library_ms": None,  # no one PyTorch call computes this function
        "shape": f"B={loc['B']} T={loc['T']}",
        # Above, the leaf route (locate_dense_kernel); here the eval's
        # route at the same shape (locate_weights_kernel).
        **{k: loc[k] for k in ("weights_ms", "weights_device_ms", "weights_plain_ms",
                               "weights_bound_ms")},
        # Every main-path shape: the leaf route and the weights route (the
        # eval's), each held to the bit, with the slices and CUDA kernels
        # of one call as the counter and the profiler saw them.
        "shapes": loc_shapes,
        "boundary_100k": {"launches": pcfg["boundary_100k"]["kernel_launches"],
                          "cuda_kernels": pcfg["boundary_100k"]["cuda_kernels"],
                          "mismatch_rate_vs_dense": pcfg["boundary_100k"]["mismatch_rate"],
                          "max_interp_diff_vs_dense": pcfg["boundary_100k"]["max_interp_diff"]},
        # Issued instructions per pair in each sweep's hot loop (bound: 13).
        "sass_per_pair": {fn: r["inner_loop"]["per_pair"]
                          for fn, r in loc_sass.items() if "inner_loop" in r},
    }, {
        "name": candmath.KERNEL,
        "route": "cuda",
        "source": "gsl_scattered_interpolation_torch/kernels/csrc/candmath2d.cu",
        "replaces": "gsl_scattered_interpolation_tpu/ops/pallas_candmath.py:43",
        "launches": dev["candmath2d_launches"],
        "launches_by_path": {"device": dev["candmath2d_launches"],
                             "build_200k_f32": b32["candmath_launches"],
                             "build_200k_f64": b64["candmath_launches"],
                             **{f"at_scale_{k}": r["candmath2d_launches"]
                                for k, r in at_scale.items()},
                             **{f"build_1m_{k}": r["candmath2d_launches"]
                                for k, r in b1m.items()},
                             **{k: r["candmath2d_launches"] for k, r in p3d.items()},
                             **{k: r["candmath2d_launches"] for k, r in prbf.items()},
                             **{k: r["candmath2d_launches"] for k, r in pcfg.items()},
                             **{f"parallel_{k}": r["candmath2d_launches"]
                                for k, r in pcfgs.items()}},
        "max_abs_err": max(
            r["max_abs_err"] for rs in (*cand_recs.values(), compact_recs) for r in rs
        ),
        "ms": c32["ms"],
        "device_ms": c32["device_ms"],
        "plain_ms": c32["plain_ms"],
        "bound_ms": c32["bound_ms"],
        "bound_by": c32["bound_by"],
        "library_ms": None,  # no one PyTorch call computes the verdict
        "shape": f"R={c32['rows']} float32",
        "float64": {k: c64[k] for k in TIMES},
        "compact_rows_float32": [{"rows": r["rows"], **{k: r[k] for k in TIMES}}
                                 for r in compact_recs],
    }, {
        "name": cells.KERNEL,
        "route": "cuda",
        "source": "gsl_scattered_interpolation_torch/kernels/csrc/cells2d.cu",
        # No Pallas kernel: the JAX package's XLA ops of the 2D branch.
        "replaces": "gsl_scattered_interpolation_tpu/models/device_tri.py:1668",
        "launches": at_scale["f32_200k"]["cells2d_launches"],
        # null where a phase keeps no count of it (the 3D phase).
        "launches_by_path": {**{f"at_scale_{k}": r["cells2d_launches"]
                                for k, r in at_scale.items()},
                             **{f"build_1m_{k}": r["cells2d_launches"]
                                for k, r in b1m.items()},
                             **{k: r.get("cells2d_launches") for k, r in p3d.items()},
                             **{k: r.get("cells2d_launches") for k, r in prbf.items()},
                             **{k: r.get("cells2d_launches") for k, r in pcfg.items()},
                             **{f"parallel_{k}": r.get("cells2d_launches")
                                for k, r in pcfgs.items()}},
        "max_abs_err": float(any(c2d["mismatches"].values())),
        **{k: c2d[k] for k in TIMES},
        "library_ms": None,  # no one PyTorch call computes this function
        "shape": f"B={c2d['B']} G={c2d['G']} K={c2d['K']}",
        "launches_per_eval": c2d["launches_per_eval"],
        "fused_per_eval": c2d["fused_per_eval"],
        # interp's route: values and walk mask, bit-equal to the tail (gated).
        "value_mode": c2d["value_mode"],
        "eval": c2d["eval"],
    }, {
        "name": walk.KERNEL,
        "route": "cuda",
        "source": "gsl_scattered_interpolation_torch/kernels/csrc/walk2d.cu",
        # No Pallas kernel: the JAX package's lockstep lax.while_loop.
        "replaces": "gsl_scattered_interpolation_tpu/models/device_tri.py:587",
        "launches": b1m["f32"]["walk2d_launches"],
        # null where a phase keeps no count of it (the 3D phase).
        "launches_by_path": {**{f"at_scale_{k}": r["walk2d_launches"]
                                for k, r in at_scale.items()},
                             **{f"build_1m_{k}": r["walk2d_launches"]
                                for k, r in b1m.items()},
                             **{k: r.get("walk2d_launches") for k, r in p3d.items()},
                             **{k: r.get("walk2d_launches") for k, r in prbf.items()},
                             **{k: r.get("walk2d_launches") for k, r in pcfg.items()},
                             **{f"parallel_{k}": r.get("walk2d_launches")
                                for k, r in pcfgs.items()}},
        # Bit-equal to the loop on every batch (walk2d_record gates it).
        "max_abs_err": float(any(any(b["mismatches"].values()) for b in w2d["batches"])),
        **{k: w2d[k] for k in TIMES},
        "library_ms": None,  # no one PyTorch call computes this function
        "shape": f"B={w2d['B']} walked={w2d['batches'][0]['walked']} T={w2d['T']}",
        "launches_per_eval": w2d["launches_per_eval"],
        "host_reads_per_eval": w2d["host_reads_per_eval"],
        "eval_ms": w2d["eval_ms"],
        "eval_ms_no_read": w2d["eval_ms_no_read"],
        "eval_ms_plain_tail": w2d["eval_ms_plain_tail"],
        "fused_per_eval": w2d["fused_per_eval"],
        # interp's route: bit-equal to the tail on every batch (gated).
        "value_mode": {**w2d["value_mode"], "max_abs_err": float(any(
            any(b["value_mismatches"].values()) for b in w2d["batches"]))},
        "eval": w2d["eval"],
    }, *tridiag_summary(pcfg)]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} was not launched on its main paths")
    log(f"at-scale summary: {json.dumps({'at_scale': at_scale, 'crossover': cross})}")
    log(f"1M summary: {json.dumps(b1m)}")
    log(f"3D summary: {json.dumps(p3d)}")
    log(f"RBF summary: {json.dumps(prbf)}")
    log(f"structured summary: {json.dumps(pcfg)}")
    log(f"parallel summary: {json.dumps(ppar)}")
    log(f"total wall: {time.perf_counter() - t_all:.2f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def facade_1m():
    """bench.py's 1M sites through ``ScatteredInterp(engine="device")`` in
    float32 with ``grid_res`` 512, as the 1M phase builds them."""
    import torch

    from gsl_scattered_interpolation_torch import ScatteredInterp
    from gsl_scattered_interpolation_torch.models.scattered import NOSTANDARDIZE

    sites = np.random.default_rng(SEED_1M).uniform(-0.5, 0.5, size=(N_1M, 2))
    return ScatteredInterp(sites, headline_values(sites), flags=NOSTANDARDIZE,
                           engine="device", dtype=torch.float32, grid_res=GRID_RES_1M)


def cells2d_main() -> int:
    """Only the cell kernel's record (:func:`cells2d_record`) on the 1M
    facade's index; the record is the last line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    rec = cells2d_record(facade_1m())
    print(json.dumps(rec))
    return 0


def walk2d_main(seed: int) -> int:
    """Only the walk kernel's record (:func:`walk2d_record`) on the
    benchmark's 1M cell as ``seed`` makes it; the record is the last line."""
    import torch

    from benchmark import generate, run
    from gsl_scattered_interpolation_torch import ScatteredInterp
    from gsl_scattered_interpolation_torch.models import scattered

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    _, config, traffic = run.cell_parts(run.load_spec(), "tri2d_1m.eval")
    sites, values = generate.problem(config, seed)
    si = ScatteredInterp(sites, values, flags=getattr(scattered, config["flags"]),
                         engine=config["engine"], dtype=getattr(torch, config["dtype"]),
                         grid_res=config["grid_res"], device="cuda")
    pool = generate.query_pool(config, traffic, seed, "cuda")
    rec = walk2d_record(si, pool)
    rec["seed"] = seed
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on CUDA cards.")
    ap.add_argument("--parallel-ranks", type=int, nargs="+", metavar="N",
                    help="only the parallel phase, at N ranks on N cards, for each N")
    ap.add_argument("--out", help="with --parallel-ranks: write every record here (JSON)")
    ap.add_argument("--cells2d", action="store_true",
                    help="only the cell kernel's record, at the 1M sites' index")
    ap.add_argument("--walk2d", action="store_true",
                    help="only the walk kernel's record, on the benchmark's 1M cell")
    ap.add_argument("--seed", type=int, default=WALK_SEED,
                    help="with --walk2d: the cell's seed")
    args = ap.parse_args()
    if args.cells2d:
        sys.exit(cells2d_main())
    if args.walk2d:
        sys.exit(walk2d_main(args.seed))
    if args.parallel_ranks:
        sys.exit(parallel_ranks_main(args.parallel_ranks, args.out))
    sys.exit(main())
