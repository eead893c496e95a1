"""Time the tridiagonal solve's two routes against each other on one CUDA
card, to set ``ops/tridiag.py``'s ``PARTITION_MIN_ROWS`` (and to re-tune
``BLOCK``: change it with ``kBlock`` in ``kernels/csrc/tridiag.cu`` and
rerun).

For float64 natural-spline systems (knot gaps in [0.5, 1.5]) at n in
{64, 128, 256, 1,024, 2,046, 10^4, 10^6} rows and m in {1, 2, 2,048} right-hand
sides it times the sequential route (``thomas_cuda``) and the partitioned
route (``partitioned_cuda``) in turns (sequential, partitioned, partitioned, sequential where a call
takes under 10 ms).  "events" is CUDA events around back-to-back wrapper
calls (host cost included), "device" the same calls queued while the card
sleeps (``chip_smoke.kernel_ms``).  Each partitioned solve is held bit-equal
to ``partitioned_ref`` on the card (except at 10^6 x 2,048, whose plain
version does not fit beside it) and within 1e-14 of max|x| of the
sequential route.  Prints one JSON record per shape, and with ``--out``
writes them all to one JSON file:

    PYTHONPATH=. python3 tools/tridiag_routes.py [--quick | --profile] [--out FILE]

``--quick`` keeps n <= 10^4 and m <= 2.
``--profile`` instead prints each partitioned kernel's device time
(``torch.profiler``, ``chip_smoke.profile_build``) over 10 solves at
n = 999,998, m = 1, at n = 999,999, m = 2 and at n = 2,046, m = 2,048,
float64, and the launch-to-launch wall time of one solve.
"""

import argparse
import json
import subprocess
import time

import torch

import chip_smoke
from gsl_scattered_interpolation_torch.kernels import build
from gsl_scattered_interpolation_torch.ops import tridiag

ROWS = (64, 128, 256, 1024, 2046, 10_000, 1_000_000)
COLS = (1, 2, 2048)
PLAIN_MAX_ELEMS = 300_000_000


def spline_system(n, m, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.rand(n + 1, generator=gen, device="cuda", dtype=torch.float64) + 0.5
    d = (2.0 * (h[1:] + h[:-1])).contiguous()
    e = h[1:-1].contiguous()
    b = torch.randn(n, m, generator=gen, device="cuda", dtype=torch.float64)
    return d, e, b


def max_abs_diff(a, b):
    """max |a - b| over row chunks: a 10^6 x 2,048 float64 difference
    would not fit beside its operands."""
    step = max(1, (1 << 26) // a.shape[1])
    return max(float((a[i:i + step] - b[i:i + step]).abs().max())
               for i in range(0, a.shape[0], step))


def timed(fn):
    """{"events": ms, "device": ms} of fn(), reps chosen from one call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    reps = max(1, min(20, int(0.2 / max(one, 1e-6))))
    return {"events": chip_smoke.time_ms(fn, reps),
            "device": chip_smoke.kernel_ms(fn, reps) if one < 0.01 else None,
            "reps": reps}


def shape_record(n, m):
    d, e, b = spline_system(n, m, n + m)
    rec = {"n": n, "m": m, "dtype": "float64",
           "bound_ms": chip_smoke.tridiag_bound_ms(n, m, True)[0]}
    seq = tridiag.thomas_cuda(d, e, b)
    scale = float(seq.abs().max())
    rec["sequential"] = [timed(lambda: tridiag.thomas_cuda(d, e, b))]
    got = tridiag.partitioned_cuda(d, e, b)
    r = {"levels": tridiag.partition_plan(n),
         "vs_sequential_rel": max_abs_diff(got, seq) / scale}
    if n * m <= PLAIN_MAX_ELEMS:
        ref = tridiag.partitioned_ref(d, e, b)
        r["mismatches"] = int((got != ref).sum())
        del ref
    del got
    torch.cuda.empty_cache()
    r["times"] = [timed(lambda: tridiag.partitioned_cuda(d, e, b)) for _ in range(2)]
    rec["partitioned"] = r
    chip_smoke.require(r["vs_sequential_rel"] <= 1e-14 and r.get("mismatches", 0) == 0,
                       f"partitioned route disagrees: {n}x{m} {r}")
    if rec["sequential"][0]["events"] < 10.0:
        rec["sequential"].append(timed(lambda: tridiag.thomas_cuda(d, e, b)))
    del seq, d, e, b
    torch.cuda.empty_cache()
    return rec


def profile(n, m, reps=10):
    d, e, b = spline_system(n, m, n + m)
    busy, wall, rows = chip_smoke.profile_build(
        lambda: [tridiag.partitioned_cuda(d, e, b) for _ in range(reps)])
    per_solve = {name: {"launches": c / reps, "ms": ms / reps}
                 for name, (c, ms) in sorted(rows.items(), key=lambda kv: -kv[1][1])}
    return {"n": n, "m": m, "busy_ms_per_solve": busy / reps,
            "wall_ms_per_solve": wall / reps, "kernels": per_solve}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(build.build(tridiag.KERNEL), flush=True)
    if args.profile:
        for n, m in ((999_998, 1), (999_999, 2), (2046, 2048)):
            print(json.dumps(profile(n, m)), flush=True)
        return
    rows = [r for r in ROWS if r <= 10_000] if args.quick else ROWS
    cols = [c for c in COLS if c <= 2] if args.quick else COLS
    recs = []
    for n in rows:
        for m in cols:
            recs.append(shape_record(n, m))
            print(json.dumps(recs[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "records": recs}, f, indent=1)


if __name__ == "__main__":
    main()
