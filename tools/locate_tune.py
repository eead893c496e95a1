"""Time the locate kernel's variants on one CUDA card, to set
the constants of ``ops/locate.py``'s ``plan``, with the
kernel of an earlier commit timed in turns beside it.

At the main path's shapes (chip_smoke.py's headline, T = 4,001, and
T = 16,001, each with 10^6 queries; bench.py's boundary check, 50,000
queries at T = 100,971) it times the leaf route at the plan's split and at
forced splits, each held leaf-equal to
``locate2d_ref`` ("device": ``chip_smoke.kernel_ms``, launches queued
while the card sleeps), and the weights route at the plan's split, held
bit-equal to ``device_tri._weights``.  With ``--parent DIR`` (an unpacked
earlier commit, from before the kernel took raw queries and their centre)
it times that commit's ``locate2d_cuda`` on the same tables and centred
queries, in turns: parent, change, change, parent.  With
``--sass FILE`` it writes the kernel's SASS there and prints its hot loop's
instructions per pair.  With ``--clocks S`` it runs each shape's kernel
for S seconds while ``nvidia-smi`` samples the SM clock and power, and
prints the issue cycles that each pair took on each of the card's
schedulers at that clock.  Prints one JSON record per shape and variant:

    PYTHONPATH=. python3 tools/locate_tune.py [--parent DIR] [--sass FILE] [--clocks S]
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

import chip_smoke
from gsl_scattered_interpolation_torch.kernels import build
from gsl_scattered_interpolation_torch.models import device_tri
from gsl_scattered_interpolation_torch.models import geometry_extras as gx
from gsl_scattered_interpolation_torch.ops import locate

FORCED_SLICES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)

# Run in the earlier commit's checkout: its own locate2d_cuda(qc, g, b) on
# the saved inputs, held against the saved plain leaves.
PARENT = r"""
import json, sys
import torch
import chip_smoke
from gsl_scattered_interpolation_torch.ops import locate
out = {}
for name, (qc, g, b, ref) in torch.load(sys.argv[1]).items():
    qc, g, b, ref = qc.cuda(), g.cuda(), b.cuda(), ref.cuda()
    got = locate.locate2d_cuda(qc, g, b)
    out[name] = {"mismatches": int((got != ref).sum()),
                 "device_ms": chip_smoke.kernel_ms(lambda: locate.locate2d_cuda(qc, g, b), 10)}
print(json.dumps(out))
"""


def shapes():
    from scipy.spatial import Delaunay

    q = chip_smoke.uniform_queries(chip_smoke.BATCH, seed=2, device="cuda")[0]
    out = {"headline": (chip_smoke.host_triangulation(chip_smoke.N_SITES, 0, "cuda"), q),
           "t16001": (chip_smoke.device_triangulation(chip_smoke.N_SITES_LARGE, 1, "cuda"), q)}
    sites, qb = chip_smoke.boundary_problem()
    tri = gx.from_scipy_delaunay(Delaunay(sites), sites, device="cuda").cast(torch.float32)
    out["boundary_100k"] = (tri, torch.tensor(qb, dtype=torch.float32, device="cuda"))
    return out


def forced_plan(slices):
    def plan(n_q, n_t, n_sms):
        length = -(-n_t // slices)
        length = -(-length // locate.GROUP) * locate.GROUP
        return -(-n_t // length), length
    return plan


def parent_times(parent, inputs):
    path = os.path.abspath(os.path.join(parent, "locate_tune_inputs.pt"))
    torch.save(inputs, path)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(parent))
    out = subprocess.run([sys.executable, "-c", PARENT, path], cwd=parent, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"parent run failed:\n{out.stdout}\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def clocks(seconds, fn):
    """(median SM MHz, median W, calls) that nvidia-smi samples every 100 ms
    while ``fn()`` runs back to back for ``seconds`` (the first third of
    the samples, the ramp, left out)."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t0, calls = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            calls += 20
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = [tuple(float(v) for v in line.split(","))
               for line in out.strip().splitlines() if line.strip()]
    samples = samples[len(samples) // 3:]
    return (statistics.median(m for m, _ in samples),
            statistics.median(w for _, w in samples), calls)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent")
    ap.add_argument("--sass")
    ap.add_argument("--clocks", type=float, default=0.0,
                    help="seconds of each shape's kernel under nvidia-smi's clock samples")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("locate_tune: no CUDA device", file=sys.stderr)
        return 1
    print(build.build(locate.KERNEL).strip() or "locate2d: built before")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi)
    if args.sass:
        tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
        with open(args.sass, "w") as f:
            subprocess.run([tool, "-sass", str(build.library_path(locate.KERNEL))],
                           stdout=f, timeout=120, check=True)
        chip_smoke.locate_sass()

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    probs = shapes()
    inputs, refs = {}, {}
    for name, (tri, q) in probs.items():
        centre, g, b = locate.pack_tables(tri)
        qc = (q - centre).contiguous()
        refs[name] = locate.locate2d_ref(qc, g, b)
        inputs[name] = (qc.cpu(), g.cpu(), b.cpu(), refs[name].cpu())
    parent = [parent_times(args.parent, inputs)] if args.parent else []

    plan = locate.plan
    for turn in range(2):
        for name, (tri, q) in probs.items():
            centre, g, b = locate.pack_tables(tri)
            B, T = q.shape[0], tri.n_tris
            bound, _ = chip_smoke.locate_bound_ms(B, T)
            auto = plan(B, T, n_sms)[0]
            for slices in (auto,) + tuple(s for s in FORCED_SLICES if s != auto):
                locate.plan = forced_plan(slices)
                got = locate.locate2d_cuda(q, g, b, centre)
                ms = chip_smoke.kernel_ms(lambda: locate.locate2d_cuda(q, g, b, centre), 10)
                print(json.dumps({
                    "turn": turn, "shape": name, "B": B, "T": T,
                    "slices": locate.plan(B, T, n_sms)[0], "planned": slices == auto,
                    "mismatches": int((got != refs[name]).sum()),
                    "device_ms": ms, "bound_ms": bound, "of_bound": bound / ms}))
            locate.plan = plan
            if args.clocks and turn == 0:
                # Issue cycles per pair: the SM clock times the card's
                # schedulers (4 a SM) over the warp instructions' pairs (32).
                mhz, watts, calls = clocks(args.clocks,
                                           lambda: locate.locate2d_cuda(q, g, b, centre))
                ms = chip_smoke.kernel_ms(lambda: locate.locate2d_cuda(q, g, b, centre), 10)
                print(json.dumps({
                    "shape": name, "clock_MHz": mhz, "power_W": watts,
                    "calls": calls, "device_ms": ms,
                    "issue_cycles_per_pair": ms * 1e-3 * mhz * 1e6 * n_sms * 4 * 32 / (B * T),
                    "bound_ms_at_clock": bound * 1980.0 / mhz}))
            leaf, w = locate.locate_weights_kernel(tri, q)
            w_ref = device_tri._weights(tri, refs[name], q)
            print(json.dumps({
                "turn": turn, "shape": name, "route": "weights",
                "mismatches": int((leaf != refs[name]).sum()),
                "weight_mismatches": int((w != w_ref).any(dim=1).sum()),
                "device_ms": chip_smoke.kernel_ms(
                    lambda: locate.locate_weights_kernel(tri, q), 10),
                "leaf_then_plain_weights_ms": chip_smoke.time_ms(lambda: device_tri._weights(
                    tri, locate.locate2d_cuda(q, g, b, centre), q), 10),
                "bound_ms": bound}))
    if args.parent:
        parent.append(parent_times(args.parent, inputs))
        print(json.dumps({"parent": parent}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
