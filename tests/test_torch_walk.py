"""Port's visibility walk (models/device_tri.locate, walk_start) vs the JAX
package's, on the same triangulation (carried across by
models/convert.from_jax_arrays)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import device_tri as jdt
from gsl_scattered_interpolation_tpu.models import host_tree as jht
from gsl_scattered_interpolation_tpu.utils import datasets

from gsl_scattered_interpolation_torch.models import convert
from gsl_scattered_interpolation_torch.models import device_tri as dt


def _port(jtri, jresp=None):
    fields = {k: np.asarray(v) for k, v in jtri._asdict().items()}
    if jresp is not None:
        fields["response"] = np.asarray(jresp)
    return convert.from_jax_arrays(fields, device="cpu")


@pytest.fixture(scope="module")
def weather():
    sites, temps = datasets.weather()
    tree = jht.build(sites, key=0)
    jtri, jresp = jdt.freeze(tree), jdt.reindex_response(tree, temps)
    tri, resp = _port(jtri, jresp)
    return tree, jtri, jresp, tri, resp


def _run(jtri, tri, Q, **kw):
    """(JAX locate, port locate) as numpy triples."""
    jkw = {k: (jnp.asarray(v, jnp.int32) if k == "start" else v) for k, v in kw.items()}
    tkw = {k: (torch.as_tensor(v) if k == "start" else v) for k, v in kw.items()}
    ref = [np.asarray(a) for a in jdt.locate(jtri, jnp.asarray(Q), **jkw)]
    ours = [a.numpy() for a in dt.locate(tri, torch.as_tensor(Q), **tkw)]
    return ref, ours


def _same(ref, ours, atol=1e-12):
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=atol)
    np.testing.assert_array_equal(ours[2], ref[2])


def test_walk_start_matches_jax(weather):
    _, jtri, _, tri, _ = weather
    Q = np.random.default_rng(3).uniform([-90.5, 40.0], [-85.5, 44.0], size=(500, 2))
    ours = dt.walk_start(tri, torch.as_tensor(Q))
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jdt.walk_start(jtri, jnp.asarray(Q))))


def test_matches_host_find_leaf(weather):
    # tests/test_device_tri.py::TestLocate::test_matches_host_find_leaf
    tree, jtri, _, tri, _ = weather
    Q = np.random.default_rng(0).uniform([-89.6, 41.0], [-86.4, 43.1], size=(200, 2))
    ref, ours = _run(jtri, tri, Q)
    _same(ref, ours)
    assert ours[2].all() and ours[1].min() > -1e-9
    for i, q in enumerate(Q):
        host = {(-p - 1) if p < 0 else 3 + p for p in tree.tri_points[tree.find_leaf(q)]}
        assert host == set(tri.tri_verts[ours[0][i]].tolist()), (i, q)


def test_walk_from_worst_start(weather):
    # tests/test_device_tri.py::TestLocate::test_walk_from_worst_start
    _, jtri, _, tri, _ = weather
    Q = np.array([[-88.0, 42.0]])
    for start in range(0, tri.n_tris, 7):
        ref, ours = _run(jtri, tri, Q, start=[start])
        _same(ref, ours)
        assert ours[1].min() > -1e-9


@pytest.mark.parametrize("max_steps", [1, 2, 3, 128])
def test_step_cap_and_outside_match_jax(weather, max_steps):
    # Starts far from the queries, so a small cap stops walks midway; the
    # last two queries walk off the cage.
    _, jtri, _, tri, _ = weather
    rng = np.random.default_rng(max_steps)
    Q = np.concatenate([
        rng.uniform([-89.6, 41.0], [-86.4, 43.1], size=(300, 2)),
        [[1e7, 1e7], [-1e7, 3e6]],
    ])
    start = rng.integers(0, tri.n_tris, size=len(Q))
    ref, ours = _run(jtri, tri, Q, start=start, max_steps=max_steps)
    _same(ref, ours)
    assert not ours[2][-2:].any()
    if max_steps == 1:
        assert not ours[2].all()


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_uniform_walk_matches_jax(dtype):
    rng = np.random.default_rng(8)
    sites = rng.uniform(-0.5, 0.5, size=(600, 2))
    jtri = jdt.freeze(jht.build(sites, flags=jht.NOSTANDARDIZE), grid_res=64)
    tri, _ = _port(jtri)
    Q = rng.uniform(-0.6, 0.6, size=(5000, 2))
    atol = 1e-12
    if dtype == "f32":
        jtri, tri, Q, atol = jtri.cast(jnp.float32), tri.cast(torch.float32), Q.astype(np.float32), 1e-6
    ref, ours = _run(jtri, tri, Q)
    _same(ref, ours, atol=atol)


def test_counts_queries_and_steps(weather):
    _, _, _, tri, _ = weather
    q, s = dt.locate.queries, dt.locate.steps
    dt.locate(tri, torch.tensor([[-88.0, 42.0], [-87.5, 41.5]], dtype=torch.float64),
              start=torch.zeros(2, dtype=torch.int64), max_steps=9)
    assert dt.locate.queries == q + 2
    assert s < dt.locate.steps <= s + 9


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_interp_walk_matches_jax(weather, dtype):
    _, jtri, jresp, tri, resp = weather
    rng = np.random.default_rng(4)
    Q = np.concatenate([
        rng.uniform([-89.5, 41.0], [-86.5, 43.1], size=(1000, 2)),
        [[1e7, 1e7]],
    ])
    atol = 1e-9
    if dtype == "f32":
        jtri, jresp, Q = jtri.cast(jnp.float32), jresp.astype(jnp.float32), Q.astype(np.float32)
        tri, resp, atol = tri.cast(torch.float32), resp.float(), 1e-5 * 300
    ref = np.asarray(jdt.interp(jtri, jresp, jnp.asarray(Q), method="walk"))
    ours = dt.interp(tri, resp, torch.as_tensor(Q), method="walk")
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=atol)
    assert ours[-1] == 0.0


def test_walk_3d_matches_jax():
    rng = np.random.default_rng(3)
    sites = rng.uniform(-0.5, 0.5, size=(40, 3))
    vals = rng.normal(size=40)
    tree = jht.build(sites, flags=jht.NOSTANDARDIZE)
    jtri, jresp = jdt.freeze(tree), jdt.reindex_response(tree, vals)
    tri, resp = _port(jtri, jresp)
    Q = rng.uniform(-0.45, 0.45, size=(300, 3))
    ref, ours = _run(jtri, tri, Q)
    _same(ref, ours)
    np.testing.assert_allclose(
        dt.interp(tri, resp, torch.as_tensor(Q), method="walk").numpy(),
        np.asarray(jdt.interp(jtri, jresp, jnp.asarray(Q), method="walk")),
        rtol=0, atol=1e-9,
    )
