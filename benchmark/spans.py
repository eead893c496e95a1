"""Reduce the program's own spans in a ``torch.profiler`` trace of the
measured window to numbers.

The port names stretches of its code with ``utils.profiling.span``: user
annotations, recorded only while a profiler records.  For each span name
other than the harness's own (``bench.*``), inside the traced window
(``trace.WINDOW_SPAN``) and on the profiler's clock:

* ``n``: the instances that overlap the window;
* ``host_s``: the union of their host intervals, clipped to the window;
* ``device_s``: the device time of the operations whose launch (the
  runtime call with the operation's correlation id) lies in an instance
  of the span and in no span nested inside it;
* ``idle_s``: the window's idle time (no device operation, busy time as
  ``trace.reduce`` takes it) that falls in the span's host intervals.

The harness drives one client thread, so spans nest by time alone.

The readers of ``metrics/`` that read these numbers (``eval.idle_in_ms``,
``eval.wait_ms``, ``cells.device_ms``, ``walk.host_ms``,
``walk.idle_ms``), the build's phases (``build.*_s``) and the blocking
reads (``eval.host_reads``) expect ``run["program_spans"]``,
``run["build_phases"]`` and the counters ``eval.host_reads.walk`` /
``.select``, which ``serve.single`` and ``systems/scattered_interp.py`` do
not yet fill.  Until they do, this module's command makes one traced run
of a cell with those three wired in around the harness, and prints the
result line with the readers' values added:

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

That stopgap (:func:`traced_run`, :func:`main`, :data:`PROGRAM_METRICS`)
goes once ``serve.single`` fills the three itself, and the idle gaps that
:func:`reduce_events` takes then come from one helper shared with
``trace.reduce``, which computes the same gaps.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import sys
from collections import defaultdict
from unittest import mock

from benchmark import trace as trace_mod

# The readers of metrics/ that read what this module and the wiring add.
PROGRAM_METRICS = ("eval.idle_in_ms", "eval.wait_ms", "eval.host_reads", "cells.device_ms",
                   "walk.host_ms", "walk.idle_ms", "build.seed_s", "build.insert_s",
                   "build.sweep_s")

# The host-side CUDA API calls (cudaLaunchKernel,
# cuLaunchKernel, cudaMemcpyAsync, ...), whose correlation id a device
# operation carries.  Known by name: the card's profiler events have no
# activity type to tell them by.
LAUNCH_NAME = re.compile(r"cu(da)?[A-Z]")


def _is_launch(e) -> bool:
    return (not trace_mod._is_device(e) and not e.is_user_annotation()
            and LAUNCH_NAME.match(e.name()) is not None)


def _union(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _overlap(a, b) -> float:
    """Total length shared by two sorted, disjoint interval lists."""
    i = j = 0
    total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _innermost(spans, points) -> list:
    """For each point (sorted times), the name of the latest-starting span
    of ``spans`` (sorted (start, end, name), nested) that contains it, or
    None."""
    out = []
    open_ = []
    i = 0
    for t in points:
        while i < len(spans) and spans[i][0] <= t:
            s, e, name = spans[i]
            while open_ and open_[-1][0] < s:
                open_.pop()
            open_.append((e, name))
            i += 1
        while open_ and open_[-1][0] < t:
            open_.pop()
        out.append(open_[-1][1] if open_ else None)
    return out


def reduce(prof) -> dict | None:
    """{span name: {"n", "host_s", "device_s", "idle_s"}} of the traced
    window; {} if the program recorded no span there, None if the trace
    holds no window."""
    return reduce_events(prof.profiler.kineto_results.events())


def reduce_events(events) -> dict | None:
    """:func:`reduce` of the profiler's raw events (``kineto_results``)."""
    window = [e for e in events
              if e.name() == trace_mod.WINDOW_SPAN and not trace_mod._is_device(e)]
    if not window:
        return None
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    spans = sorted(
        (e.start_ns(), e.end_ns(), e.name()) for e in events
        if not trace_mod._is_device(e) and e.is_user_annotation()
        and not e.name().startswith("bench.") and e.end_ns() > w0 and e.start_ns() < w1
    )
    if not spans:
        return {}
    dev = [
        (max(e.start_ns(), w0), min(e.end_ns(), w1), e.correlation_id())
        for e in events
        if trace_mod._is_device(e) and not trace_mod._is_harness(e)
        and e.end_ns() > w0 and e.start_ns() < w1
    ]
    # Idle: the window less the union of device intervals, as trace.reduce.
    gaps = []
    cur = w0
    for s, t in _union((s, t) for s, t, _ in dev):
        if s > cur:
            gaps.append([cur, s])
        cur = max(cur, t)
    if w1 > cur:
        gaps.append([cur, w1])
    launched = {e.correlation_id(): e.start_ns() for e in events if _is_launch(e)}
    ops = sorted((launched[c], t - s) for s, t, c in dev if c in launched)
    device_ns = defaultdict(float)
    for name, (_, d) in zip(_innermost(spans, [o[0] for o in ops]), ops):
        if name is not None:
            device_ns[name] += d
    by_name = defaultdict(list)
    for s, t, name in spans:
        by_name[name].append((max(s, w0), min(t, w1)))
    out = {}
    for name, iv in by_name.items():
        host = _union(iv)
        out[name] = {
            "n": len(iv),
            "host_s": sum(t - s for s, t in host) * 1e-9,
            "device_s": device_ns[name] * 1e-9,
            "idle_s": _overlap(host, gaps) * 1e-9,
        }
    return out


def per_request(run, name: str, field: str):
    """``field`` of the span ``name`` per traced request, or None where
    the run holds no such span (an untraced run, or a program without it)."""
    spans = run.get("program_spans") or {}
    if name not in spans or not run["traced_queries"]:
        return None
    return spans[name][field] / (run["traced_queries"] / run["traffic"]["batch"])


def device_traced(run) -> bool:
    """Whether the traced window saw any device operation (a card run)."""
    t = run["trace"]
    return bool(t) and t["busy_s"] > 0


def traced_run(workload, seed, seconds, device="cuda", given=None):
    """(result, run) of one traced run of ``workload`` (``run.execute``),
    with the program's spans, build phases and blocking reads wired in
    and ``result["program_metrics"]`` holding :data:`PROGRAM_METRICS`."""
    from benchmark import parts, run
    from gsl_scattered_interpolation_torch.models import device_tri

    spec = run.load_spec()
    _, config, _ = run.cell_parts(spec, workload) if given is None else given
    system = parts.find("systems", config["system"])
    reduce_trace, build, counters, read_metrics = (
        trace_mod.reduce, system.build, system.counters, run.read_metrics)
    extra, runs = {}, []

    def reduce_both(prof):
        extra["program_spans"] = reduce(prof)
        return reduce_trace(prof)

    def build_keeping_phases(*args, **kw):
        entry = build(*args, **kw)
        extra["build_phases"] = getattr(getattr(entry, "__self__", None), "build_stats", None)
        return entry

    def counters_with_reads():
        return dict(counters(), **{"eval.host_reads.walk": device_tri.locate.host_reads,
                                   "eval.host_reads.select": device_tri.locate_cells_host_reads})

    def read_with_extra(metrics, r):
        r.update(extra)
        runs.append(r)
        return read_metrics(metrics, r)

    patches = [(trace_mod, "reduce", reduce_both), (system, "build", build_keeping_phases),
               (system, "counters", counters_with_reads), (run, "read_metrics", read_with_extra)]
    with contextlib.ExitStack() as stack:
        for module, name, new in patches:
            stack.enter_context(mock.patch.object(module, name, new))
        result = run.execute(workload, seed, seconds, True, device=device, spec=spec,
                             given=given)
    r = runs[-1]
    values = {name: run.reader(name)(r) for name in PROGRAM_METRICS}
    result["program_metrics"] = {k: v for k, v in values.items() if v is not None}
    result["program_spans"] = r.get("program_spans")
    result["traced_requests"] = r["traced_queries"] // r["traffic"]["batch"]
    return result, r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One traced run of a cell with the program's spans.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("benchmark.spans: needs a CUDA card", file=sys.stderr)
        return 1
    result, _ = traced_run(args.workload, args.seed, args.seconds)
    forbidden = result.pop("_forbidden")
    if forbidden:
        print(f"benchmark: loaded {', '.join(forbidden)}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
