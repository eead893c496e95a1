"""Port's models/thinning.py with the device builder vs the JAX package,
on the CPU, in float64: tests/test_thinning.py::test_device_builder_small's
input, ``keep`` and ``rounds`` equal and ``max_error`` within 1e-12, and the
kept triangulation reproducing every dropped site within tol."""

import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import thinning as jthinning

from gsl_scattered_interpolation_torch.models import device_tri, thinning

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_device_builder_equals_jax():
    rng = np.random.default_rng(9)
    sites = rng.uniform(0.0, 4.0, size=(300, 2))
    vals = np.sin(sites[:, 0]) + 0.3 * np.cos(2 * sites[:, 1])
    kw = dict(tol=0.05, key=4, seed_frac=1 / 8.0)
    res = thinning.thin(sites, vals, device=CPU, **kw)
    want = jthinning.thin(sites, vals, **kw)
    np.testing.assert_array_equal(res.keep, want.keep)
    assert res.rounds == want.rounds
    assert abs(res.max_error - want.max_error) <= 1e-12
    assert res.max_error <= 0.05 and res.keep.size < len(sites)
    drop = np.setdiff1d(np.arange(len(sites)), res.keep)
    resp = device_tri.response_for_build(res.shuffle, vals[res.keep], device=CPU)
    est = device_tri.interp(res.tri, resp, torch.tensor(sites[drop])).numpy()
    assert np.abs(est - vals[drop]).max() <= 0.05
