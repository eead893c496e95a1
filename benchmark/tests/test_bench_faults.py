"""The check fails what it must: the TF32 control, and runs with the timed
path broken underneath (the card check skipped, everything else a run)."""

import pytest

from benchmark import control
from benchmark.tests.helpers import execute_small, small_parts


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_fault_under_the_single_card_path_is_not_correct(fault, restore_port):
    res = execute_small("tri2d_2k.eval", fault=fault, batch=1000, sample_rows=512)
    assert res["correct"] is False and res["failed"] > 0
    c = res["checks"]["err_max"]
    assert c["value"] > c["limit"]


# The 1M configuration at 10,000 sites takes the cell index and the walk
# on the CPU (T = 20,001, past the brute force's 16,384); the 2k one the
# brute force.
@pytest.mark.parametrize("workload, sites", [("tri2d_2k.eval", 2000),
                                             ("tri2d_1m.eval", 10000)])
def test_neighbouring_triangle_is_not_correct(workload, sites, restore_port):
    res = execute_small(workload, fault="neighbour", sites=sites, seconds=0.5,
                        sample_rows=1024)
    assert res["correct"] is False and res["failed"] > 0
    c = res["checks"]["err_max"]
    assert c["value"] > 3 * c["limit"]


@pytest.mark.parametrize("workload", ["tri2d_2k.eval", "tri2d_1m.eval"])
def test_tf32_control_fails_its_limit(workload):
    _, config, traffic = small_parts(workload, sites=2000, batch=20000, sample_rows=512)
    got = control.reading(config, traffic, 2**31 + 99, "cpu")
    assert got["err_max"] > 3 * got["limit"]


@pytest.mark.parametrize("workload, sites", [("tri2d_2k.eval", 2000),
                                             ("tri2d_1m.eval", 10000)])
def test_sound_run_reads_well_under_its_limit(workload, sites):
    res = execute_small(workload, sites=sites, seconds=0.5, sample_rows=1024)
    c = res["checks"]["err_max"]
    assert res["correct"] is True and c["value"] < c["limit"] / 10
