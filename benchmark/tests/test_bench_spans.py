"""``benchmark/spans.py`` and the readers of the program's spans, build
phases and host reads: synthetic profiler events, hand-made run dicts and
a traced CPU run of a small cell."""

import functools
import json
from pathlib import Path

import pytest
import torch

from benchmark import run as bench_run
from benchmark import spans
from benchmark.tests.helpers import small_parts
from gsl_scattered_interpolation_torch.models import device_delaunay
from gsl_scattered_interpolation_torch.models import device_tri as dt

ROOT = Path(__file__).resolve().parents[2]
PROGRAM_SPANS = ("scattered.eval", "device_tri.locate_cells.score",
                 "device_tri.locate_cells.select", "device_tri.locate")


# -- benchmark/spans.py on synthetic events --------------------------------------


class _Event:
    def __init__(self, name, start, end, device=False, annotation=False, corr=0):
        self._v = (name, start, end, device, annotation, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


def _span(name, s, e):
    return _Event(name, s, e, annotation=True)


def _launch(t, corr):
    return _Event("cudaLaunchKernel", t, t + 1, corr=corr)


def _kernel(s, e, corr):
    return _Event("kernel", s, e, device=True, corr=corr)


CASES = {
    # Each kernel goes to the innermost span that holds its launch.
    "innermost_by_correlation": (
        [_span("bench.window", 0, 100), _span("outer", 10, 90), _span("inner", 20, 40),
         _launch(15, 1), _launch(25, 2), _launch(50, 3), _kernel(30, 35, 1),
         _kernel(36, 46, 2), _kernel(60, 70, 3),
         _Event("aten::mul", 24, 27, corr=2)],  # an op whose id is a kernel's
        {"outer": {"n": 1, "host_s": 80, "device_s": 15, "idle_s": 55},
         "inner": {"n": 1, "host_s": 20, "device_s": 10, "idle_s": 11}},
    ),
    # Idle is the window less the device's busy union, inside the span.
    "idle_gap_in_a_span": (
        [_span("bench.window", 0, 100), _span("a", 10, 50), _launch(1, 7), _launch(2, 8),
         _kernel(0, 20, 7), _kernel(40, 60, 8), _kernel(45, 55, 9)],
        {"a": {"n": 1, "host_s": 40, "device_s": 0, "idle_s": 20}},
    ),
    # Spans and kernels are clipped to the window; spans outside it drop.
    "clipped_to_the_window": (
        [_span("early", 0, 40), _span("a", 0, 100), _span("bench.window", 50, 150),
         _span("a", 120, 200), _launch(60, 1), _kernel(40, 70, 1), _kernel(140, 160, 2)],
        {"a": {"n": 2, "host_s": 80, "device_s": 20, "idle_s": 50}},
    ),
    # The harness's own spans are not the program's, and hold no kernel.
    "bench_spans_ignored": (
        [_span("bench.window", 0, 100), _span("bench.request", 10, 90), _span("a", 20, 30),
         _launch(15, 1), _launch(25, 2), _kernel(40, 50, 1), _kernel(50, 60, 2)],
        {"a": {"n": 1, "host_s": 10, "device_s": 10, "idle_s": 10}},
    ),
}


@pytest.mark.parametrize("case", list(CASES))
def test_reduce_events(case):
    events, want = CASES[case]
    got = spans.reduce_events(events)
    assert set(got) == set(want)
    for name, fields in want.items():
        assert got[name]["n"] == fields["n"]
        for k in ("host_s", "device_s", "idle_s"):
            assert got[name][k] == pytest.approx(fields[k] * 1e-9, abs=1e-15), (name, k)


def test_reduce_events_without_window_or_spans():
    assert spans.reduce_events([_span("a", 0, 10)]) is None
    assert spans.reduce_events([_span("bench.window", 0, 10), _kernel(1, 2, 1)]) == {}


# -- readers ---------------------------------------------------------------------


def _run(**extra):
    """A run dict as ``serve.single`` and ``run.execute`` leave it."""
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "eval_20m.json").read_text())
    r = {
        "setup_s": 17.0, "build_s": 4.0, "window_s": 30.0, "requests": 450,
        "queries": 450 * traffic["batch"], "traced_queries": 73 * traffic["batch"],
        "latency_s": [0.065, 0.066, 0.07], "spans": {"eval.host": [0.06, 0.061]},
        "counters": {"walk.queries": 4_000_000, "walk.steps": 6_200},
        "trace": {"busy_s": 3.97, "window_s": 5.05, "kernel_s": {"::locate2d_kernel": 0.1},
                  "device_ops": [], "idle_gaps": []},
        "memory_peak_bytes": 1, "verdict": {}, "forbidden": [], "traffic": traffic,
    }
    for k, v in extra.items():
        r[k] = dict(r[k], **v) if isinstance(v, dict) and k in r else v
    return r


NEW_KEYS = dict(
    program_spans={
        "scattered.eval": {"n": 73, "host_s": 4.9, "device_s": 0.13, "idle_s": 1.07},
        "device_tri.locate_cells.score": {"n": 73, "host_s": 0.18, "device_s": 3.75,
                                          "idle_s": 0.02},
        "device_tri.locate_cells.select": {"n": 73, "host_s": 3.65, "device_s": 0.0,
                                           "idle_s": 0.04},
        "device_tri.locate": {"n": 73, "host_s": 1.04, "device_s": 0.08, "idle_s": 0.96},
    },
    build_phases={"seed_s": 3.0, "insert_s": 0.27, "sweep_s": 0.14, "seeded": True},
    counters={"eval.host_reads.walk": 1997, "eval.host_reads.select": 450},
)
SPEC = bench_run.load_spec()
ACCEPTED = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]


@pytest.mark.parametrize("name", ACCEPTED)
def test_accepted_readers_ignore_the_new_keys(name):
    read = bench_run.reader(name)
    assert read(_run()) == read(_run(**NEW_KEYS))


@pytest.mark.parametrize("name, want", [
    ("eval.idle_in_ms", 1e3 * 1.07 / 73),
    ("eval.wait_ms", 1e3 * 3.65 / 73),
    ("eval.host_reads", (1997 + 450) / 450),
    ("cells.device_ms", 1e3 * 3.75 / (73 * 20)),
    ("walk.host_ms", 1e3 * 1.04 / 73),
    ("walk.idle_ms", 1e3 * 0.96 / 73),
    ("build.seed_s", 3.0),
    ("build.insert_s", 0.27),
    ("build.sweep_s", 0.14),
])
def test_program_readers(name, want):
    assert name in spans.PROGRAM_METRICS
    read = bench_run.reader(name)
    assert read(_run(**NEW_KEYS)) == pytest.approx(want, rel=1e-12)
    assert read(_run()) is None  # a program or a harness without them


def test_device_readers_read_nothing_without_device_time():
    cpu = _run(**NEW_KEYS)
    cpu["trace"] = dict(cpu["trace"], busy_s=0.0)
    for name in ("eval.idle_in_ms", "walk.idle_ms"):
        assert bench_run.reader(name)(cpu) is None


def test_traced_run_on_the_cpu_reads_the_program(monkeypatch):
    monkeypatch.setattr(dt, "DENSE_LOCATE_MAX_TRIS", 200)
    monkeypatch.setattr(device_delaunay, "triangulate", functools.partial(
        device_delaunay.triangulate, chunk_threshold=500, seed_min=500))
    res, r = spans.traced_run("tri2d_1m.eval", 2**31 + 5, 1.0, device="cpu",
                              given=small_parts("tri2d_1m.eval", sites=3000, batch=20000))
    got = res["program_metrics"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(r["program_spans"]) == set(PROGRAM_SPANS)
    assert r["program_spans"]["scattered.eval"]["n"] == res["traced_requests"] > 0
    # A CPU run has no device timeline: no device metric is read.
    assert not {"cells.device_ms", "eval.idle_in_ms", "walk.idle_ms"} & set(got)
    assert {"eval.wait_ms", "walk.host_ms", "build.seed_s", "build.insert_s",
            "build.sweep_s"} <= set(got)
    steps = res["metrics"]["walk.steps_per_batch"]["value"]
    assert 1 + steps / dt.WALK_DONE_EVERY < got["eval.host_reads"]
    assert got["eval.host_reads"] <= 2 + steps / dt.WALK_DONE_EVERY
    assert sum(got[f"build.{p}_s"] for p in ("seed", "insert", "sweep")) < r["build_s"]
