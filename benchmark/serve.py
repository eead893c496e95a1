"""Set-up, the measured window and the check of one run of a cell.

:func:`single` makes the cell's inputs from the seed, builds the
configuration's system (``systems/<system>.py``), warms every batch of the
pool, drives the traffic's loop (``loops/<loop>.py``) for the window, and,
once the window has closed and the program's state is freed, holds the
stored answers against the plain reference.  It returns a plain dict,
``run``, that the metric readers read.
"""

from __future__ import annotations

import gc
import importlib
import json
import sys
import time

import torch

from benchmark import check, generate
from benchmark import trace as trace_mod
from benchmark.parts import find

FORBIDDEN = ("jax", "jaxlib", "flax", "gsl_scattered_interpolation_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or its package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def single(config, traffic, seed, seconds, trace, device, t_process, fault=None) -> dict:
    """One run of a one-device cell."""
    if fault:
        importlib.import_module("benchmark.tests.faults").apply(fault)
    system = find("systems", config["system"])
    # Set-up's phases, each from the end of the one before (the first from
    # process start): printed on an earlier line of every run.
    phases = {}
    t_last = [t_process]

    def phase(name, sync=True):
        if sync:
            _sync(device)
        now = time.perf_counter()
        phases[name] = now - t_last[0]
        t_last[0] = now

    phase("imports_s", sync=False)  # the benchmark's, torch's and the port's
    torch.empty(1, device=device)
    phase("device_s")  # the device's context
    sites, values = generate.problem(config, seed)
    phase("problem_s")
    entry = system.build(config, sites, values, device)
    phase("build_s")
    pool = generate.query_pool(config, traffic, seed, device)
    rows = generate.sample_rows(traffic, seed, device)
    loop = find("loops", traffic["loop"]).Loop(traffic, pool, rows, device)
    phase("inputs_s")
    host = []

    def request(batch, batch_rows, out, timed=True):
        t0 = time.perf_counter()
        answers = entry(batch)
        if timed and not loop.profiling:
            host.append(time.perf_counter() - t0)
        torch.index_select(answers, 0, batch_rows, out=out)

    per_request_s = loop.warm(lambda b, r, o: request(b, r, o, timed=False))
    phase("warm_s")
    print(f"build_s {phases['build_s']!r}", flush=True)
    print(f"setup_phases {json.dumps(phases)}", flush=True)
    prof = _profiler(device) if trace else None
    if prof is not None:
        prof.start()
    c0 = system.counters()
    window_s = loop.run(request, seconds, per_request_s, prof=prof)
    c1 = system.counters()
    traced = trace_mod.reduce(prof) if prof is not None else None
    del prof
    memory_peak = _memory_peak(device)
    stored, slots = loop.judged()
    queries = loop.sampled_queries()
    del entry, pool, loop.pool, request
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    P, S, dim = queries.shape
    _, ties, _ = check.reference(config, sites, values, queries.reshape(-1, dim), device)
    verdict = check.judge(stored, slots, ties.reshape(P, S, -1), config["limits"]["err_max"])
    print(f"reference_s {time.perf_counter() - t0!r}", flush=True)
    n = len(loop.latency)
    return {
        "setup_s": loop.t_start - t_process,
        "build_s": phases["build_s"],
        "window_s": window_s,
        "requests": n,
        "queries": n * traffic["batch"],
        "traced_queries": loop.untraced_from * traffic["batch"],
        "latency_s": loop.untraced(loop.latency) if trace else loop.latency,
        "spans": {"eval.host": host},
        "counters": {k: c1[k] - c0[k] for k in c0},
        "trace": traced,
        "memory_peak_bytes": memory_peak,
        "verdict": verdict,
        "forbidden": forbidden_modules(),
    }
