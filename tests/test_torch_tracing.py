"""The port's spans and counters (``utils.profiling.span``, the walk's and
the cell index's host reads, ``ScatteredInterp.build_stats``), on the
CPU, and the walk kernel's host reads on a card (marked ``cuda``).  No
JAX."""

import functools
import time

import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_torch.models import device_delaunay, scattered
from gsl_scattered_interpolation_torch.models import device_tri as dt
from gsl_scattered_interpolation_torch.utils import profiling

PROGRAM_SPANS = ("scattered.eval", "device_tri.locate_cells.score",
                 "device_tri.locate_cells.select", "device_tri.locate")


@functools.cache
def _interp(n=400, seed=3):
    sites = np.random.default_rng(seed).uniform(-0.5, 0.5, size=(n, 2))
    return scattered.ScatteredInterp(sites, np.sin(3 * sites[:, 0]), engine="device",
                                     device="cpu")


def _queries(seed, n=512):
    return torch.as_tensor(np.random.default_rng(seed).uniform(-0.45, 0.45, size=(n, 2)))


def _eval_through_cells(si, q, monkeypatch, K=2):
    """``si.eval`` on the cell index's route with a walk fallback: K = 2
    overflows most cells."""
    monkeypatch.setattr(si, "_cells", dt.build_cell_index(si.tri, K=K))
    return si.eval(q)


def _user_annotations(prof):
    return [e for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


# -- profiling.span ----------------------------------------------------------


def test_span_without_a_profiler_calls_no_record_function(monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    with profiling.span("outer"):
        pass
    si = _interp()
    walked = dt.locate.queries
    _eval_through_cells(si, _queries(1), monkeypatch)
    assert dt.locate.queries > walked  # every span of the program was passed


def test_span_under_a_profiler_records_nested_annotations(monkeypatch):
    si = _interp()
    q = _queries(1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(8).sum()
        _eval_through_cells(si, q, monkeypatch)
    ann = {e.name(): (e.start_ns(), e.end_ns()) for e in _user_annotations(prof)}
    assert {"outer", "inner", *PROGRAM_SPANS} <= set(ann)
    inside = lambda a, b: ann[b][0] <= ann[a][0] and ann[a][1] <= ann[b][1]  # noqa: E731
    assert inside("inner", "outer")
    for name in PROGRAM_SPANS[1:]:
        assert inside(name, "scattered.eval")
    assert not inside("device_tri.locate", "device_tri.locate_cells.score")
    assert ann["device_tri.locate_cells.select"][1] <= ann["device_tri.locate"][0]


@pytest.mark.parametrize("K, want", [
    (None, {"scattered.eval"}),  # brute force: no cell index, no walk
    (32, {"scattered.eval", "device_tri.locate_cells.score",
          "device_tri.locate_cells.select"}),  # the index settles every query
    (2, set(PROGRAM_SPANS)),  # the index and the walk
])
def test_an_eval_records_the_spans_of_its_route(monkeypatch, K, want):
    si = _interp()
    if K is not None:
        monkeypatch.setattr(si, "_cells", dt.build_cell_index(si.tri, K=K))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        si.eval(_queries(4))
    names = [e.name() for e in _user_annotations(prof)]
    assert set(names) == want
    assert all(names.count(n) == 1 for n in want)


# -- host_reads ----------------------------------------------------------------


def test_walk_reads_once_per_done_test(monkeypatch):
    si = _interp()
    cells = dt.build_cell_index(si.tri, K=2)
    q = _queries(2)
    before = (dt.locate.queries, dt.locate.steps, dt.locate.host_reads,
              dt.locate_cells_host_reads)
    dt.locate_cells(si.tri, cells, q, fallback_steps=32)
    walked, steps, walk_reads, select_reads = (
        a - b for a, b in zip((dt.locate.queries, dt.locate.steps, dt.locate.host_reads,
                               dt.locate_cells_host_reads), before))
    assert walked > 0 and 0 < steps < 32  # the walk ended on its test of done
    assert select_reads == 1
    # Tests of done at steps 0, WALK_DONE_EVERY, ..., the last one true.
    assert walk_reads == steps // dt.WALK_DONE_EVERY + 1


@pytest.mark.cuda
def test_kernel_walk_reads_once_on_the_card():
    # 2D float32 queries on the card walk in one kernel launch: one read
    # of its largest iteration count, beside the select read, per call.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tri = _interp().tri.to("cuda").cast(torch.float32)
    cells = dt.build_cell_index(tri, K=2)
    for seed in (2, 3):
        q = _queries(seed).to("cuda", torch.float32)
        before = (dt.locate.queries, dt.locate.steps, dt.locate.host_reads,
                  dt.locate_cells_host_reads)
        dt.locate_cells(tri, cells, q, fallback_steps=32)
        walked, steps, walk_reads, select_reads = (
            a - b for a, b in zip((dt.locate.queries, dt.locate.steps, dt.locate.host_reads,
                                   dt.locate_cells_host_reads), before))
        assert walked > 0 and 0 < steps <= 32
        assert steps % dt.WALK_DONE_EVERY == 0 or steps == 32  # the loop's count
        assert walk_reads <= 1 and select_reads == 1


def test_index_alone_reads_once():
    si = _interp()
    cells = dt.build_cell_index(si.tri, K=32)  # no cell overflows
    before = dt.locate.queries, dt.locate.host_reads, dt.locate_cells_host_reads
    dt.locate_cells(si.tri, cells, _queries(3))
    walked, walk_reads, select_reads = (
        a - b for a, b in zip((dt.locate.queries, dt.locate.host_reads,
                               dt.locate_cells_host_reads), before))
    assert walked == 0 and walk_reads == 0
    assert select_reads == 1  # nonzero is read even when it finds nothing


def test_select_read_counts_under_a_wrapper(monkeypatch):
    # A wrapper of the module's locate_cells (as the benchmark's neighbour
    # fault is) that calls the original leaves the count whole.
    si = _interp()
    cells = dt.build_cell_index(si.tri, K=32)
    original = dt.locate_cells
    monkeypatch.setattr(dt, "locate_cells", lambda *a, **kw: original(*a, **kw))
    before = dt.locate_cells_host_reads
    dt.locate_cells(si.tri, cells, _queries(3))
    assert dt.locate_cells_host_reads == before + 1


# -- ScatteredInterp.build_stats ---------------------------------------------------


@pytest.mark.parametrize("engine, keys", [
    ("device", {"setup_s", "seed_s", "seeded", "rounds"}),
    ("host", set()),
])
def test_build_stats_are_kept(engine, keys):
    sites = np.random.default_rng(5).uniform(-0.5, 0.5, size=(300, 2))
    si = scattered.ScatteredInterp(sites, sites[:, 0], engine=engine, device="cpu")
    assert set(si.build_stats) >= keys and bool(si.build_stats) == bool(keys)


def test_chunked_build_phases_end_within_the_build(monkeypatch):
    monkeypatch.setattr(device_delaunay, "triangulate", functools.partial(
        device_delaunay.triangulate, chunk_threshold=500, seed_min=500))
    sites = np.random.default_rng(6).uniform(-0.5, 0.5, size=(3000, 2))
    t0 = time.perf_counter()
    si = scattered.ScatteredInterp(sites, sites[:, 0], engine="device", device="cpu")
    build_s = time.perf_counter() - t0
    st = si.build_stats
    assert st["seeded"] and min(st["seed_s"], st["insert_s"], st["sweep_s"]) > 0
    assert st["seed_s"] + st["insert_s"] + st["sweep_s"] < build_s
