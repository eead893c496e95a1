"""eval_roofline's arithmetic: each query read once (8 bytes), each value
written once (4 bytes), 25 operations; never the brute-force pair count."""

import pytest

from benchmark import peaks, run

READ = run.reader("eval_roofline")


def test_floor_is_bytes_bound_at_the_data_sheet_rates():
    q = 10**6
    assert peaks.eval_floor_s(q) == pytest.approx(12e6 / 3.35e12)
    assert 25e6 / 33.5e12 < 12e6 / 3.35e12


@pytest.mark.parametrize("busy_s, want", [(12e6 / 3.35e12, 100.0), (2.1e-3, 0.170574)])
def test_share_of_busy_time(busy_s, want):
    got = READ({"trace": {"busy_s": busy_s}, "traced_queries": 10**6})
    assert got == pytest.approx(want, rel=1e-5)


def test_independent_of_the_triangle_count():
    # The floor counts no triangle, so a culling or index change cannot
    # read above 100 % by doing less than brute force.
    spec = run.load_spec()
    names = {m["name"] for m in spec["per_layer"]}
    assert "eval_roofline" in names
    assert peaks.EVAL_BYTES_PER_QUERY == 12 and peaks.EVAL_OPS_PER_QUERY == 25


@pytest.mark.parametrize("trace", [None, {"busy_s": 0.0}])
def test_nothing_to_read_reads_nothing(trace):
    assert READ({"trace": trace, "traced_queries": 10**6}) is None
