"""Port's models/geometry_extras.py vs the JAX package, on the CPU.

Hull edges and Voronoi ridges equal, Voronoi centres within 1e-12, both on
the same device build (the port's and JAX's builds are row-equal,
tests/test_torch_device_delaunay.py) and on a JAX triangulation carried
across; ``from_scipy_delaunay`` with integer fields equal and affine maps
within 1e-15, evaluating as JAX's import does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import ConvexHull, Delaunay as ScipyDelaunay

from gsl_scattered_interpolation_tpu.models import device_delaunay as jdd
from gsl_scattered_interpolation_tpu.models import device_tri as jdt
from gsl_scattered_interpolation_tpu.models import geometry_extras as jgx
from gsl_scattered_interpolation_tpu.models import host_tree as jht

from gsl_scattered_interpolation_torch.models import convert, device_delaunay as dd
from gsl_scattered_interpolation_torch.models import device_tri, geometry_extras as gx
from gsl_scattered_interpolation_torch.models import host_tree

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sites(n=120, seed=0):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=(n, 2))


def _carried(jtri):
    fields = {f: np.asarray(getattr(jtri, f)) for f in jtri._fields}
    fields["grid_res"] = int(jtri.grid_res)
    return convert.from_jax_arrays(fields, device=CPU)[0]


@pytest.mark.parametrize("n,seed", [(120, 0), (60, 1), (300, 5)])
def test_hull_matches_jax_and_scipy(n, seed):
    sites = _sites(n, seed)
    jtri, jshuffle = jdd.triangulate(sites, flags=jht.NOSTANDARDIZE)
    tri, shuffle = dd.triangulate(sites, flags=host_tree.NOSTANDARDIZE, device=CPU)
    np.testing.assert_array_equal(shuffle, jshuffle)
    for t in (tri, _carried(jtri)):
        np.testing.assert_array_equal(gx.convex_hull_edges(t), jgx.convex_hull_edges(jtri))
        ids = gx.convex_hull_points(t)
        np.testing.assert_array_equal(ids, jgx.convex_hull_points(jtri))
        np.testing.assert_array_equal(np.sort(shuffle[ids]), np.sort(ConvexHull(sites).vertices))


@pytest.mark.parametrize("n,seed", [(60, 1), (200, 2)])
def test_voronoi_matches_jax(n, seed):
    sites = _sites(n, seed)
    jtri, _ = jdd.triangulate(sites, flags=jht.NOSTANDARDIZE)
    tri, _ = dd.triangulate(sites, flags=host_tree.NOSTANDARDIZE, device=CPU)
    jv, jr = jgx.voronoi(jtri)
    for t in (tri, _carried(jtri)):
        v, r = gx.voronoi(t)
        np.testing.assert_array_equal(r, jr)
        assert v.shape == jv.shape
        assert np.abs(v - jv).max() <= 1e-12


def test_voronoi_of_a_3d_triangulation():
    sites = np.random.default_rng(4).uniform(-0.5, 0.5, (80, 3))
    jtri = jgx.from_scipy_delaunay(ScipyDelaunay(sites), sites)
    v, r = gx.voronoi(_carried(jtri))
    jv, jr = jgx.voronoi(jtri)
    np.testing.assert_array_equal(r, jr)
    assert np.abs(v - jv).max() <= 1e-12


@pytest.mark.parametrize("d,n,seed", [(2, 80, 2), (2, 50, 4), (3, 60, 6)])
def test_from_scipy_delaunay_matches_jax(d, n, seed):
    sites = np.random.default_rng(seed).uniform(-0.5, 0.5, (n, d))
    sd = ScipyDelaunay(sites)
    jtri = jgx.from_scipy_delaunay(sd, sites)
    tri = gx.from_scipy_delaunay(sd, sites, device=CPU)
    assert tri.dtype == torch.float64 and tri.device.type == "cpu"
    for f in dataclasses.fields(tri):
        got, want = getattr(tri, f.name), getattr(jtri, f.name)
        if f.name == "grid_res":
            assert got == want
        elif f.name == "affine":
            assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-15 * max(
                1.0, np.abs(np.asarray(want)).max())
        else:  # ids, grid, points, shift and scale
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vals = np.sin(4 * sites[:, 0]) + sites[:, 1]
    resp = device_tri.response_for_build(np.arange(n), vals, d=d, device=CPU)
    q = np.random.default_rng(3).uniform(-0.4, 0.4, size=(300, d))
    ours = device_tri.interp(tri, resp, torch.tensor(q)).numpy()
    theirs = np.asarray(jdt.interp(jtri, jnp.concatenate([jnp.zeros(d + 1), jnp.asarray(vals)]),
                                   jnp.asarray(q)))
    assert np.abs(ours - theirs).max() <= 1e-9
    # Beyond the hull the imported mesh is out of domain.
    assert float(device_tri.interp(tri, resp, torch.full((1, d), 5.0, dtype=torch.float64))[0]) == 0.0
