"""Port's models/rbf_pu.py vs the JAX package, on the CPU, in float64.

On the CPU the JAX package solves uncompacted patches (W = 9 cap); the port
compacts every neighborhood to its populated slots on every device (the
route a TPU user of the JAX package ran), the same systems without their
decoupled identity rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import rbf_compact as jrc
from gsl_scattered_interpolation_tpu.models import rbf_pu as jpu

from gsl_scattered_interpolation_torch.models import convert, rbf_pu
from gsl_scattered_interpolation_torch.utils import errors

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores, and eight threads per worker oversubscribe them many times over
    on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n, seed=0):
    rng = np.random.default_rng(seed)
    sites = rng.uniform(-2.0, 1.0, size=(n, 2))
    vals = np.sin(2 * sites[:, 0]) * np.cos(sites[:, 1]) + 0.1 * sites[:, 1]
    return sites, vals


@pytest.fixture(scope="module")
def fits():
    sites, vals = _problem(400, seed=1)
    stats = {}
    ours = rbf_pu.fit(sites, vals, chunk=64, device=CPU, stats=stats)
    return sites, vals, jpu.fit(sites, vals, chunk=64), ours, stats


def test_neighborhood9_equal():
    xs = np.random.default_rng(2).uniform(-0.5, 0.5, (500, 2))
    grid = jrc.build_cell_grid(xs, 0.1)
    want = np.asarray(jpu._neighborhood9(grid.xs_pad))
    got = rbf_pu._neighborhood9(torch.tensor(np.asarray(grid.xs_pad)))
    np.testing.assert_array_equal(got.numpy(), want)
    v = np.asarray(grid.xs_pad)[..., 0]
    np.testing.assert_array_equal(
        rbf_pu._neighborhood9(torch.tensor(v)[..., None], fill=0.0).numpy(),
        np.asarray(jpu._neighborhood9(jnp.asarray(v)[..., None], fill=0.0)))


def test_carried_fit_evaluates_as_jax(fits):
    sites, _, ref, _, _ = fits
    carried = convert.pu_tps_from_jax(ref._asdict(), device=CPU)
    assert carried.xs9.shape == ref.xs9.shape
    q = np.concatenate([np.random.default_rng(3).uniform(-2.2, 1.2, (2000, 2)), sites[:200],
                        [[50.0, 50.0]]])
    got = rbf_pu.evaluate(carried, q).numpy()
    np.testing.assert_allclose(got, np.asarray(jpu.evaluate(ref, q)), rtol=0, atol=1e-12)
    assert got[-1] == 0.0  # far outside every patch: fade to zero


def test_fit_matches_jax(fits):
    sites, vals, ref, ours, stats = fits
    assert ours.lam.dtype == torch.float64
    assert stats["grid"] == list(ref.shape) and ours.shape == ref.shape
    assert stats["W"] == ref.xs9.shape[2] and stats["W2"] == ours.xs9.shape[2] < stats["W"]
    assert ours.cell == ref.cell and ours.rad == ref.rad
    np.testing.assert_array_equal(ours.poly.shape, ref.poly.shape)
    q = np.random.default_rng(4).uniform(-2.0, 1.0, (2000, 2))
    np.testing.assert_allclose(rbf_pu.evaluate(ours, q).numpy(), np.asarray(jpu.evaluate(ref, q)),
                               rtol=0, atol=1e-8)
    # test_rbf_pu.py:22's interpolation tolerance
    np.testing.assert_allclose(rbf_pu.evaluate(ours, sites).numpy(), vals, rtol=0, atol=5e-8)
    np.testing.assert_allclose(ours.poly.numpy(), np.asarray(ref.poly), rtol=0, atol=1e-8)


def test_float32_fit_interpolates(fits):
    sites, vals, _, ours64, _ = fits
    m = rbf_pu.fit(sites, vals, dtype=torch.float32, device=CPU)
    assert m.lam.dtype == torch.float32
    assert np.max(np.abs(rbf_pu.evaluate(m, sites).numpy() - vals)) < 1e-4
    q = np.random.default_rng(5).uniform(-1.9, 0.9, (500, 2))
    diff = rbf_pu.evaluate(m, q).numpy() - rbf_pu.evaluate(ours64, q).numpy()
    assert np.max(np.abs(diff)) < 1e-4


def test_arguments_checked():
    with pytest.raises(errors.InvalidArgumentError):
        rbf_pu.fit(np.zeros((10, 3)), np.zeros(10), device=CPU)
    with pytest.raises(errors.InvalidArgumentError):
        rbf_pu.fit(np.zeros((10, 2)), np.zeros(9), device=CPU)
