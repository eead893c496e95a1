"""Port's models/thinning.py vs the JAX package, on the CPU, in float64,
with the Qhull builder (tests/test_torch_thinning_device.py has the device
builder).

tests/test_thinning.py's 2D inputs through both packages: ``keep`` and
``rounds`` equal and ``max_error`` within 1e-12.  The contract is held
independently by scipy's LinearNDInterpolator over the kept sites, 0 beyond
their hull (an imported mesh is out of domain there, and so gives 0).  The
JAX runs take most of the time (each round's new size compiles), so the
other inputs of tests/test_thinning.py run through the port alone.
"""

import numpy as np
import pytest
import torch
from scipy.interpolate import LinearNDInterpolator

from gsl_scattered_interpolation_tpu.models import thinning as jthinning

from gsl_scattered_interpolation_torch.models import thinning

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smooth_problem(n, seed=0):
    rng = np.random.default_rng(seed)
    sites = rng.uniform(0.0, 4.0, size=(n, 2))
    vals = np.sin(sites[:, 0]) + 0.3 * np.cos(2 * sites[:, 1])
    return sites, vals


def _linear_problem():
    rng = np.random.default_rng(3)
    sites = rng.uniform(-1, 1, size=(800, 2))
    return sites, 2.0 * sites[:, 0] - sites[:, 1] + 0.25


CASES = {
    "error_bound": lambda: (*_smooth_problem(1200), dict(tol=0.02, key=1)),
    "linear_field": lambda: (*_linear_problem(), dict(tol=1e-8, key=2)),
}


def _contract(res, sites, vals, tol):
    """The largest miss at a dropped site, by scipy over the kept sites."""
    drop = np.setdiff1d(np.arange(len(sites)), res.keep)
    est = LinearNDInterpolator(sites[res.keep], vals[res.keep], fill_value=0.0)(sites[drop])
    return np.abs(est - vals[drop]).max()


def _same(ours, theirs):
    np.testing.assert_array_equal(ours.keep, theirs.keep)
    assert ours.rounds == theirs.rounds
    assert abs(ours.max_error - theirs.max_error) <= 1e-12


@pytest.mark.parametrize("case", sorted(CASES))
def test_qhull_builder_equals_jax(case):
    sites, vals, kw = CASES[case]()
    res = thinning.thin(sites, vals, builder="qhull", device=CPU, **kw)
    _same(res, jthinning.thin(sites, vals, builder="qhull", **kw))
    assert res.max_error <= kw["tol"]
    assert _contract(res, sites, vals, kw["tol"]) <= kw["tol"] + 1e-12


def test_tight_tol_keeps_more():
    sites, vals = _smooth_problem(600, seed=5)
    loose = thinning.thin(sites, vals, tol=0.05, key=3, builder="qhull", device=CPU)
    tight = thinning.thin(sites, vals, tol=0.002, key=3, builder="qhull", device=CPU)
    assert tight.keep.size > loose.keep.size
    for res, tol in ((loose, 0.05), (tight, 0.002)):
        assert res.max_error <= tol
        assert _contract(res, sites, vals, tol) <= tol + 1e-12


def test_3d_routes_to_qhull():
    rng = np.random.default_rng(7)
    sites = rng.uniform(0.0, 2.0, size=(1500, 3))
    vals = np.sin(sites[:, 0]) + 0.3 * np.cos(2 * sites[:, 1]) + 0.2 * sites[:, 2]
    res = thinning.thin(sites, vals, tol=0.05, key=6, device=CPU)
    assert res.max_error <= 0.05 and res.keep.size < len(sites)
    assert res.tri.dim == 3
    assert _contract(res, sites, vals, 0.05) <= 0.05 + 1e-12
