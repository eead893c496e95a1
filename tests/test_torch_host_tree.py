"""Port's host engine, geometry, rng and small utils vs the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import host_tree as jht
from gsl_scattered_interpolation_tpu.ops import geometry as jgeo
from gsl_scattered_interpolation_tpu.utils import datasets as jdatasets
from gsl_scattered_interpolation_tpu.utils import errors as jerrors
from gsl_scattered_interpolation_tpu.utils import machine as jmachine
from gsl_scattered_interpolation_tpu.utils import rng as jrng

from gsl_scattered_interpolation_torch.models import host_tree as ht
from gsl_scattered_interpolation_torch.ops import geometry as geo
from gsl_scattered_interpolation_torch.utils import datasets, errors, machine, rng


def _simplex_set(tree):
    """Leaves as sorted tuples of (shuffled) site rows; cage ids stay < 0."""
    out = set()
    for node in tree.leaves():
        pts = tree.tri_points[node]
        rows = [int(tree.shuffle[p]) if p >= 0 else int(p) for p in pts]
        out.add(tuple(sorted(rows)))
    return out


def _cases():
    sites, _ = datasets.weather()
    rand = np.random.default_rng(42).uniform(-0.5, 0.5, size=(300, 2))
    return {"weather": (sites, 0), "random300": (rand, 1)}


@pytest.mark.parametrize("case", ["weather", "random300"])
@pytest.mark.parametrize("method", ["cavity", "flips"])
def test_simplex_sets_equal(case, method):
    sites, seed = _cases()[case]
    perm = jrng.insertion_shuffle(seed, len(sites))
    jtree = jht.build(sites, key=seed, method=method)
    tree = ht.build(sites, key=perm, method=method)
    np.testing.assert_array_equal(tree.shuffle, jtree.shuffle)
    assert tree.n_simplexes == jtree.n_simplexes
    np.testing.assert_array_equal(tree.seed_points, jtree.seed_points)
    assert _simplex_set(tree) == _simplex_set(jtree)


@pytest.mark.parametrize("flags", [ht.DEFAULT, ht.NOSTANDARDIZE, ht.ISOSCALE])
def test_identity_shuffle_and_flags(flags):
    sites = np.random.default_rng(7).uniform(-2.0, 3.0, size=(60, 2)) * [1, 4]
    jtree = jht.build(sites, flags=flags)
    tree = ht.build(sites, flags=flags)
    np.testing.assert_array_equal(tree.shuffle, np.arange(60))
    np.testing.assert_array_equal(tree.scale, jtree.scale)
    assert _simplex_set(tree) == _simplex_set(jtree)
    q = np.array([0.3, 1.7])
    assert tree.interp(np.arange(60.0), q) == jtree.interp(np.arange(60.0), q)


def test_rng_keys():
    np.testing.assert_array_equal(rng.insertion_shuffle(None, 5), np.arange(5))
    p = rng.insertion_shuffle(3, 50)
    np.testing.assert_array_equal(np.sort(p), np.arange(50))
    np.testing.assert_array_equal(p, rng.insertion_shuffle(3, 50))
    jp = jrng.insertion_shuffle(3, 50)
    np.testing.assert_array_equal(rng.insertion_shuffle(jp, 50), jp)
    for bad in (np.zeros(50, int), np.arange(49)):
        with pytest.raises(errors.InvalidArgumentError):
            rng.insertion_shuffle(bad, 50)


@pytest.mark.parametrize("dim", [1, 2, 3, 5])
def test_cage_matches_jax(dim):
    shift, scale = np.linspace(-1, 1, dim), np.linspace(0.5, 2, dim)
    np.testing.assert_array_equal(geo.regular_simplex(dim), jgeo.regular_simplex(dim))
    for dt in (np.float64, np.float32):
        np.testing.assert_array_equal(
            geo.cage_vertices(dim, shift, scale, dt),
            jgeo.cage_vertices(dim, shift, scale, dt),
        )


def test_standardization_and_orient_match_jax():
    rng_ = np.random.default_rng(0)
    lo, hi = np.array([-1.0, 2.0, 5.0]), np.array([1.0, 2.0, 9.0])
    shift, scale = geo.shift_scale_from_bounds(lo, hi)
    jshift, jscale = jgeo.shift_scale_from_bounds(jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(shift.numpy(), np.asarray(jshift))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        geo.isotropic_scale(scale).numpy(), np.asarray(jgeo.isotropic_scale(jscale))
    )
    x = rng_.normal(size=(10, 3))
    np.testing.assert_array_equal(
        geo.standardize(torch.as_tensor(x), shift, scale).numpy(),
        np.asarray(jgeo.standardize(jnp.asarray(x), jshift, jscale)),
    )
    a, b, c = (rng_.normal(size=(10, 2)) for _ in range(3))
    np.testing.assert_array_equal(
        geo.orient2d(*(torch.as_tensor(v) for v in (a, b, c))).numpy(),
        np.asarray(jgeo.orient2d(*(jnp.asarray(v) for v in (a, b, c)))),
    )


def test_machine_errors_datasets_match_jax():
    for dt in (np.float32, np.float64):
        assert machine.eps(dt) == jmachine.eps(dt)
        assert machine.sqrt_eps(dt) == jmachine.sqrt_eps(dt)
        assert machine.root5_eps(dt) == jmachine.root5_eps(dt)
    assert machine.eps(torch.float32) == jmachine.eps(np.float32)
    assert machine.DBL_EPSILON == jmachine.DBL_EPSILON
    for code in (errors.EDOM, errors.EINVAL, errors.ESING, errors.ETABLE, 99):
        with pytest.raises(errors.GslError) as ours:
            errors.check_status(code)
        with pytest.raises(jerrors.GslError) as ref:
            jerrors.check_status(code)
        assert type(ours.value).__name__ == type(ref.value).__name__
        assert ours.value.code == ref.value.code
    errors.check_status(errors.SUCCESS)
    for ours, ref in zip(datasets.weather(), jdatasets.weather()):
        np.testing.assert_array_equal(ours, ref)


def test_capacity_and_domain_errors():
    with pytest.raises(errors.CapacityError):
        ht.build(np.zeros((3, 2)), capacity=2)
    tree = ht.SimplexTree(dim=2, capacity=4)
    with pytest.raises(errors.InvalidArgumentError):
        tree.init()
    tree = ht.build(np.array([[0.0, 0.0], [1.0, 1.0]]))
    assert tree.find_leaf(np.array([1e30, 1e30])) == -1
    assert tree.interp(np.ones(2), np.array([1e30, 1e30])) == 0.0
