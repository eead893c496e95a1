#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

Usage, from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version on the card, drives the main
path (``ScatteredInterp(engine="host")`` and ``.eval`` on 10 batches of a
million queries, at the size of bench.py's headline), checks the result
against the matmul brute force and against scipy, and times it all.

Earlier lines are diagnostics.  The line before the last is one JSON object
with a record for each kernel; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or if any phase
fails, it exits non-zero and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_SITES = 2000          # bench.py headline: T = 2 * 2000 + 1 = 4001
N_SITES_LARGE = 8000    # T = 16001, just under the brute-force limit
BATCH = 1_000_000
N_BATCHES = 10
N_CHECK = 100_000       # queries held against dense locate and scipy
EVAL_VS_DENSE_MAX = 1e-3   # bench.py's gate between the two locates
EVAL_VS_SCIPY_MAX = 1e-4   # float32 values of O(1)
# H100 SXM data sheet: 67 TFLOP/s float32 counts an FMA as two operations,
# so one non-FMA float32 instruction per lane and clock is 33.5e12 per s.
F32_OPS_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12
LOCATE_OPS_PER_PAIR = 13   # 4 mul, 4 add, 2 sub, 2 min, 1 compare


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def headline_problem(n_sites: int, seed: int):
    """Sites uniform in [-0.5, 0.5]^2 and bench.py's test function."""
    rng = np.random.default_rng(seed)
    sites = rng.uniform(-0.5, 0.5, size=(n_sites, 2))
    values = np.sin(6 * sites[:, 0]) * np.cos(6 * sites[:, 1])
    return sites, values


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


def locate_bound_ms(n_q: int, n_t: int):
    """(least ms, "operations" or "bytes") for the locate of n_q x n_t."""
    ops_ms = 1e3 * LOCATE_OPS_PER_PAIR * n_q * n_t / F32_OPS_PER_S
    # queries in (8 B) and leaves out (4 B) once, the tables (24 B) once
    bytes_ms = 1e3 * (12 * n_q + 24 * n_t) / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def check_locate(tri, q):
    """Kernel against its plain version on the same tables and queries,
    with the times of both and the kernel's bound."""
    from gsl_scattered_interpolation_torch.ops import locate

    centre, g_pack, b_pack = locate.pack_tables(tri)
    qc = (q - centre).contiguous()
    ref = locate.locate2d_ref(qc, g_pack, b_pack)
    got = locate.locate2d_cuda(qc, g_pack, b_pack)
    diff = (got.long() - ref.long()).abs()
    rec = {"B": int(q.shape[0]), "T": int(tri.n_tris)}
    rec["mismatches"] = int((diff != 0).sum())
    rec["max_abs_err"] = float(diff.max())
    rec["ms"] = time_ms(lambda: locate.locate2d_cuda(qc, g_pack, b_pack), 10)
    rec["plain_ms"] = time_ms(lambda: locate.locate2d_ref(qc, g_pack, b_pack), 2)
    rec["bound_ms"], rec["bound_by"] = locate_bound_ms(q.shape[0], tri.n_tris)
    return rec


def main_path(device, n_sites: int, batch: int, n_batches: int, n_check: int):
    """Build the facade and evaluate ``n_batches`` query batches.

    Returns a dict of what was measured and checked; raises on a failed
    check.
    """
    import torch

    from gsl_scattered_interpolation_torch import ScatteredInterp
    from gsl_scattered_interpolation_torch.models import device_tri
    from gsl_scattered_interpolation_torch.models.scattered import NOSTANDARDIZE
    from scipy.interpolate import LinearNDInterpolator

    sites, values = headline_problem(n_sites, seed=0)
    t0 = time.perf_counter()
    si = ScatteredInterp(
        sites, values, flags=NOSTANDARDIZE, engine="host", device=device
    )
    build_s = time.perf_counter() - t0
    Q = uniform_queries(batch, seed=1, device=device, batches=n_batches)

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [si.eval(Q[i]) for i in range(n_batches)]
    if cuda:
        torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0

    out0 = outs[0][:n_check]
    require(
        out0.shape == (n_check,) and bool(torch.isfinite(out0).all()),
        f"eval gave {tuple(out0.shape)} or non-finite values",
    )
    q0 = Q[0, :n_check]
    dense = device_tri.interp(si.tri, si.response, q0, method="dense")
    vs_dense = float((out0 - dense).abs().max())
    ref = LinearNDInterpolator(sites, values)(q0.double().cpu().numpy())
    inside = np.isfinite(ref)
    vs_scipy = float(
        np.abs(out0.double().cpu().numpy()[inside] - ref[inside]).max()
    )
    require(inside.sum() > 0.99 * n_check, f"{inside.sum()} queries in the hull")
    require(vs_dense < EVAL_VS_DENSE_MAX, f"eval vs dense locate {vs_dense}")
    require(vs_scipy < EVAL_VS_SCIPY_MAX, f"eval vs scipy {vs_scipy}")
    return {
        "n_simplexes": si.n_simplexes,
        "host_build_s": build_s,
        "eval_s": eval_s,
        "queries_per_s": batch * n_batches / eval_s,
        "eval_vs_dense_max": vs_dense,
        "eval_vs_scipy_max": vs_scipy,
    }


def main() -> int:
    t_all = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 1
    from gsl_scattered_interpolation_torch.kernels import build
    from gsl_scattered_interpolation_torch.ops import locate

    # 1. Device.
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    log(f"phase device: {time.perf_counter() - t0:.2f} s")

    # 2. Build every kernel of the path from the sources.
    t0 = time.perf_counter()
    log(f"nvcc {locate.KERNEL}:\n{build.build(locate.KERNEL).strip()}")
    log(f"phase build: {time.perf_counter() - t0:.2f} s")

    # 3. Kernel against its plain version at T = 4001 and T = 16001.
    t0 = time.perf_counter()
    records = []
    for n_sites, seed in ((N_SITES, 0), (N_SITES_LARGE, 1)):
        tri = host_triangulation(n_sites, seed, "cuda")
        q = uniform_queries(BATCH, seed=2, device="cuda")[0]
        rec = check_locate(tri, q)
        log(f"locate2d kernel vs plain: {json.dumps(rec)}")
        require(rec["mismatches"] == 0, f"locate2d disagrees with its plain version: {rec}")
        records.append(rec)
    torch.cuda.synchronize()
    log(f"phase kernel-vs-plain: {time.perf_counter() - t0:.2f} s")

    # 4. Main path, counted from zero.
    t0 = time.perf_counter()
    locate.locate2d_cuda.launches = 0
    res = main_path("cuda", N_SITES, BATCH, N_BATCHES, N_CHECK)
    launches = locate.locate2d_cuda.launches
    res["locate2d_launches"] = launches
    log(f"main path: {json.dumps(res)}")
    require(launches > 0, "the main path never launched locate2d")
    log(f"phase main-path: {time.perf_counter() - t0:.2f} s")

    main_rec = records[0]
    kernels = [{
        "name": locate.KERNEL,
        "route": "cuda",
        "source": "gsl_scattered_interpolation_torch/kernels/csrc/locate2d.cu",
        "replaces": "gsl_scattered_interpolation_tpu/ops/pallas_locate.py:35",
        "launches": launches,
        "max_abs_err": main_rec["max_abs_err"],
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": None,  # no one PyTorch call computes this function
        "shape": f"B={main_rec['B']} T={main_rec['T']}",
    }]
    log(f"total wall: {time.perf_counter() - t_all:.2f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
