"""Reduce a ``torch.profiler`` trace of the measured window to numbers.

The traced window is the CPU span named ``bench.window`` that the harness
records around the first requests of a traced run (``serve.TRACE_S``);
busy time, idle gaps and kernel time are taken inside it, on the
profiler's own clock.  (``profile_eval.py`` in the port divides
the profiler's busy time by a mean timed in another loop; here both come
from the same window.)
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

WINDOW_SPAN = "bench.window"
TOP = 10
# Idle gaps shorter than this (nanoseconds) are left unlabelled.
MIN_GAP_NS = 2000
# How far back the search for a gap's host op looks.
LOOKBACK = 256


def _is_device(e) -> bool:
    return e.device_type() != torch.autograd.DeviceType.CPU


def _is_harness(e) -> bool:
    # The harness's own spans, which the profiler also marks on the device
    # timeline as annotations.
    return e.name().startswith("bench.") or e.is_user_annotation()


def reduce(prof) -> dict | None:
    """{"busy_s", "window_s", "kernel_s" {name: s}, "device_ops", "idle_gaps"}
    of the traced window, or None if the trace holds no window.

    Reads the profiler's raw events (``kineto_results``), which take a
    fraction of the time ``prof.events()`` takes to build its op tree.
    """
    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.name() == WINDOW_SPAN and not _is_device(e)]
    if not window:
        return None
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    dev = sorted(
        (max(e.start_ns(), w0), min(e.end_ns(), w1), e.name())
        for e in events
        if _is_device(e) and not _is_harness(e) and e.end_ns() > w0 and e.start_ns() < w1
    )
    kernel_ns = defaultdict(float)
    busy = 0
    gaps = []
    cur_end = w0
    for s, t, name in dev:
        kernel_ns[name] += t - s
        if s > cur_end:
            gaps.append((cur_end, s))
        if t > cur_end:
            busy += t - max(s, cur_end)
            cur_end = t
    if w1 > cur_end:
        gaps.append((cur_end, w1))
    # Label each gap by what the host was doing at its middle: the innermost
    # host op that covers it (the latest-starting one), and the next one out.
    host = sorted(
        ((e.start_ns(), e.end_ns(), e.name()) for e in events
         if not _is_device(e) and not _is_harness(e)),
    )
    starts = [h[0] for h in host]
    by_label = defaultdict(float)
    for g0, g1 in gaps:
        if g1 - g0 < MIN_GAP_NS:
            continue
        mid = 0.5 * (g0 + g1)
        names = []
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - LOOKBACK, -1), -1):
            if host[j][1] >= mid:
                names.append(host[j][2])
                if len(names) == 2:
                    break
        label = " > ".join(reversed(names))[:100] or "host: harness"
        by_label[label] += (g1 - g0) * 1e-9
    top_ops = sorted(kernel_ns.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy * 1e-9,
        "window_s": (w1 - w0) * 1e-9,
        "kernel_s": {k: v * 1e-9 for k, v in kernel_ns.items()},
        "device_ops": [[k[:100], v * 1e-9] for k, v in top_ops],
        "idle_gaps": [[k, v] for k, v in top_gaps],
    }
