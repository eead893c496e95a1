"""Port's ScatteredInterp(engine="host") vs the JAX facade, and the slice
as a whole: host build -> freeze -> locate -> eval on a headline-like
problem, against the JAX package's own path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu import ScatteredInterp as JaxInterp
from gsl_scattered_interpolation_tpu.models import device_tri as jdt
from gsl_scattered_interpolation_tpu.models import host_tree as jht
from gsl_scattered_interpolation_tpu.utils import datasets, rng as jrng

from gsl_scattered_interpolation_torch import ScatteredInterp
from gsl_scattered_interpolation_torch.models import device_tri
from gsl_scattered_interpolation_torch.utils import errors


@pytest.fixture(scope="module")
def weather():
    sites, temps = datasets.weather()
    perm = jrng.insertion_shuffle(0, len(sites))
    ref = JaxInterp(sites, temps, key=0, engine="host")
    ours = {
        dt: ScatteredInterp(sites, temps, key=perm, engine="host", device="cpu", dtype=dt)
        for dt in (torch.float64, torch.float32)
    }
    rng = np.random.default_rng(0)
    Q = np.concatenate([
        rng.uniform([-89.5, 41.0], [-86.5, 43.1], size=(600, 2)),
        [[1e7, 1e7], [-1e7, 3e6]],  # outside the cage
    ])
    return sites, temps, ref, ours, Q


# f64: the 1e-9 of tests/test_device_tri.py; f32: 1e-5 of the response scale.
def _atol(dtype, temps):
    return 1e-9 if dtype == torch.float64 else 1e-5 * float(np.abs(temps).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_eval_matches_jax(weather, dtype):
    sites, temps, ref, ours, Q = weather
    si = ours[dtype]
    assert si.n_simplexes == ref.n_simplexes
    v = si.eval(Q)
    assert v.dtype == dtype
    np.testing.assert_allclose(v.numpy(), np.asarray(ref.eval(Q)), rtol=0, atol=_atol(dtype, temps))
    assert v[-1] == 0.0 and v[-2] == 0.0
    np.testing.assert_allclose(si.eval(sites).numpy(), temps, rtol=0, atol=_atol(dtype, temps) * 100)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_eval_e_matches_jax(weather, dtype):
    _, temps, ref, ours, Q = weather
    v, s = ours[dtype].eval_e(Q)
    jv, js = ref.eval_e(Q)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[-1] == errors.EDOM and s[0] == errors.SUCCESS
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=_atol(dtype, temps))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_eval_deriv_matches_jax(weather, dtype):
    _, temps, ref, ours, Q = weather
    g = ours[dtype].eval_deriv(Q).numpy()
    jg = np.asarray(ref.eval_deriv(Q))
    if dtype == torch.float64:
        np.testing.assert_allclose(g, jg, rtol=1e-9, atol=1e-9)
    else:
        # A query within f32 noise of an edge may sit in the neighbour,
        # whose gradient differs; everywhere else the gradients agree.
        close = np.all(np.isclose(g, jg, rtol=1e-4, atol=1e-3), axis=1)
        assert close.mean() > 0.99
    assert np.all(g[-2:] == 0)


def test_strict_and_arguments(weather):
    sites, temps, _, ours, _ = weather
    si = ours[torch.float64]
    with pytest.raises(errors.DomainError):
        si.eval([[1e7, 1e7]], strict=True)
    si.eval([[-88.0, 41.5]], strict=True)
    with pytest.raises(errors.InvalidArgumentError):
        ScatteredInterp(sites, temps[:-1], engine="host", device="cpu")
    with pytest.raises(errors.InvalidArgumentError):
        ScatteredInterp(sites[:, 0], temps, engine="host", device="cpu")
    with pytest.raises(errors.InvalidArgumentError):
        ScatteredInterp(sites, temps, engine="nope", device="cpu")


@pytest.mark.parametrize("engine,d", [("cavity", 3), ("auto", 3)])
def test_device_engines_come_later(one_torch_thread, engine, d):
    # The cavity engine has come: "auto" takes it for d = 3, and a linear
    # function is reproduced at the sites.
    sites = np.random.default_rng(0).uniform(size=(10, d))
    vals = sites @ np.array([1.0, -2.0, 0.5])
    si = ScatteredInterp(sites, vals, engine=engine, device="cpu")
    assert si.engine == "cavity" and si.tri.dim == 3
    np.testing.assert_allclose(si.eval(sites).numpy(), vals, rtol=0, atol=1e-9)


@pytest.mark.parametrize(
    "device_type,dtype,want",
    [("cuda", torch.float32, "pallas"), ("cuda", torch.float64, "dense"),
     ("cpu", torch.float32, "dense"), ("cpu", torch.float64, "dense")],
)
def test_auto_method_sends_only_float32_to_the_kernel(device_type, dtype, want):
    lim = device_tri.DENSE_LOCATE_MAX_TRIS
    assert device_tri.auto_method(device_type, 2, dtype, 101, False) == want
    assert device_tri.auto_method(device_type, 2, dtype, 101, True) == "cells"
    assert device_tri.auto_method(device_type, 3, dtype, 101, False) == "dense"
    assert device_tri.auto_method(device_type, 2, dtype, lim + 1, False) == "walk"


@pytest.fixture(scope="module")
def reanchor_queries(weather):
    """ROADMAP Queue C item 1: 200,000 queries over the weather set, and
    the JAX facade's float64 values there."""
    Q = np.random.default_rng(2).uniform([-89, 41.2], [-87, 42.8], (200000, 2))
    return Q, np.asarray(weather[2].eval(Q))


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_auto_route_keeps_every_query(weather, reanchor_queries, device_type, dtype):
    # Each route that "auto" picks, run here on the CPU (the kernel's
    # route through its plain version, which the card tests hold
    # leaf-equal to the kernel), against the JAX float64 values.
    _, temps, _, ours, _ = weather
    Q, ref = reanchor_queries
    si = ours[dtype]
    q = si._queries(Q)
    method = device_tri.auto_method(device_type, 2, dtype, si.n_simplexes, False)
    v = device_tri.interp(si.tri, si.response, q, method=method).numpy()
    np.testing.assert_allclose(v, ref, rtol=0, atol=_atol(dtype, temps))
    if dtype == torch.float64:
        # The float32 tables drop some of these queries in float64.
        lost = device_tri.interp(si.tri, si.response, q, method="pallas").numpy()
        assert np.sum(np.abs(lost - ref) > 1.0) > 0


def test_host_engine_any_dimension():
    rng = np.random.default_rng(4)
    sites = rng.uniform(-0.5, 0.5, size=(15, 4))
    vals = rng.normal(size=15)
    perm = jrng.insertion_shuffle(1, 15)
    Q = rng.uniform(-0.2, 0.2, size=(50, 4))
    ref = np.asarray(JaxInterp(sites, vals, key=1).eval(Q))  # auto = host for d=4
    ours = ScatteredInterp(sites, vals, key=perm, device="cpu").eval(Q)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-9)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_slice_end_to_end_matches_jax_headline_path(dtype):
    # bench.py's headline path at a small size: host build with
    # NOSTANDARDIZE, freeze, brute-force locate, eval.
    rng = np.random.default_rng(0)
    sites = rng.uniform(-0.5, 0.5, size=(200, 2))
    values = np.sin(6 * sites[:, 0]) * np.cos(6 * sites[:, 1])
    Q = rng.uniform(-0.45, 0.45, size=(2000, 2))
    tree = jht.build(sites, flags=jht.NOSTANDARDIZE)
    jtri, jresp = jdt.freeze(tree, grid_res=128), jdt.reindex_response(tree, values)
    torch_dtype, atol = torch.float64, 1e-9
    if dtype == "f32":
        jtri, jresp, Q = jtri.cast(jnp.float32), jresp.astype(jnp.float32), Q.astype(np.float32)
        torch_dtype, atol = torch.float32, 1e-5
    ref = np.asarray(jdt.interp(jtri, None, jnp.asarray(Q), method="dense",
                                resp_tri=jdt.vertex_responses(jtri, jresp)))
    si = ScatteredInterp(sites, values, flags=1, engine="host", device="cpu", dtype=torch_dtype)
    for method in ("auto", "pallas"):
        ours = device_tri.interp(si.tri, si.response, si._queries(Q), method=method)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=atol)
    np.testing.assert_allclose(si.eval(Q).numpy(), ref, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def weather_device():
    """The JAX facade's device engine and the port's, on the same
    permutation, in float64 and float32."""
    sites, temps = datasets.weather()
    perm = jrng.insertion_shuffle(0, len(sites))
    refs = {
        dt: JaxInterp(sites, temps, key=0, engine="device", dtype=jdt)
        for dt, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32))
    }
    rng = np.random.default_rng(1)
    Q = np.concatenate([
        rng.uniform([-89.5, 41.0], [-86.5, 43.1], size=(600, 2)),
        [[1e7, 1e7], [-1e7, 3e6]],  # outside the cage
    ])
    return sites, temps, perm, refs, Q


@pytest.mark.parametrize("engine", ["device", "auto"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_device_engine_matches_jax(weather_device, engine, dtype):
    sites, temps, perm, refs, Q = weather_device
    ref = refs[dtype]
    si = ScatteredInterp(sites, temps, key=perm, engine=engine, device="cpu", dtype=dtype)
    assert si.engine == "device" and si.tree is None
    assert si.n_simplexes == ref.n_simplexes == 2 * len(sites) + 1
    np.testing.assert_array_equal(si.shuffle, np.asarray(ref.shuffle))
    np.testing.assert_array_equal(si.tri.tri_verts.numpy(), np.asarray(ref.tri.tri_verts))
    atol = _atol(dtype, temps)
    v = si.eval(Q)
    assert v.dtype == dtype and v[-1] == 0.0 and v[-2] == 0.0
    np.testing.assert_allclose(v.numpy(), np.asarray(ref.eval(Q)), rtol=0, atol=atol)
    vals, status = si.eval_e(Q)
    jv, js = ref.eval_e(Q)
    np.testing.assert_array_equal(status.numpy(), np.asarray(js))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=0, atol=atol)
    g = si.eval_deriv(Q).numpy()
    jg = np.asarray(ref.eval_deriv(Q))
    if dtype == torch.float64:
        np.testing.assert_allclose(g, jg, rtol=1e-9, atol=1e-9)
    else:
        # A query within f32 noise of an edge may sit in the neighbour.
        close = np.all(np.isclose(g, jg, rtol=1e-4, atol=1e-3), axis=1)
        assert close.mean() > 0.99


def test_device_engine_headline_path_matches_jax():
    # bench.py's headline problem at a small size through the device engine:
    # build with NOSTANDARDIZE, freeze, brute-force locate, eval.
    rng = np.random.default_rng(0)
    sites = rng.uniform(-0.5, 0.5, size=(200, 2))
    values = np.sin(6 * sites[:, 0]) * np.cos(6 * sites[:, 1])
    Q = rng.uniform(-0.45, 0.45, size=(2000, 2))
    ref = np.asarray(JaxInterp(sites, values, flags=1, engine="device").eval(Q))
    si = ScatteredInterp(sites, values, flags=1, engine="device", device="cpu")
    for method in ("dense", "pallas"):
        ours = device_tri.interp(si.tri, si.response, si._queries(Q), method=method)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-9)


def test_device_engine_limits():
    with pytest.raises(NotImplementedError, match="2D"):
        ScatteredInterp(np.zeros((5, 3)), np.zeros(5), engine="device", device="cpu")


def _jax_facade_at_scale(monkeypatch, sites, vals):
    """The JAX facade (auto = device engine) with the brute-force limit set
    low, so that it answers through its lazy cell index."""
    monkeypatch.setattr(jdt, "DENSE_LOCATE_MAX_TRIS", 8)
    return JaxInterp(sites, vals, key=0)


def _same_surfaces(si, ref, Q):
    """eval, eval_e and eval_deriv of the port and the JAX facade agree to
    1e-9 in float64."""
    v = si.eval(Q)
    np.testing.assert_allclose(v.numpy(), np.asarray(ref.eval(Q)), rtol=0, atol=1e-9)
    vals, status = si.eval_e(Q)
    jv, js = ref.eval_e(Q)
    np.testing.assert_array_equal(status.numpy(), np.asarray(js))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=0, atol=1e-9)
    np.testing.assert_allclose(si.eval_deriv(Q).numpy(), np.asarray(ref.eval_deriv(Q)),
                               rtol=1e-9, atol=1e-9)
    return v


def test_lazy_cell_index_path(monkeypatch):
    # tests/test_scattered_api.py::TestFacadeAtScale::test_lazy_cell_index_path,
    # held against the JAX facade on the same permutation.
    rng = np.random.default_rng(3)
    sites = rng.uniform(-0.5, 0.5, size=(600, 2))
    vals = np.sin(3 * sites[:, 0]) + sites[:, 1]
    ref = _jax_facade_at_scale(monkeypatch, sites, vals)
    si = ScatteredInterp(sites, vals, key=np.asarray(ref.shuffle), device="cpu")
    monkeypatch.setattr(device_tri, "DENSE_LOCATE_MAX_TRIS", 8)
    Q = rng.uniform(-0.45, 0.45, size=(500, 2))
    v = _same_surfaces(si, ref, Q)
    cells = si._cells
    assert cells is not None and cells.complete
    assert si._get_cells() is cells  # built once, then cached
    dense = device_tri.interp(si.tri, si.response, si._queries(Q), method="dense")
    np.testing.assert_allclose(v.numpy(), dense.numpy(), rtol=0, atol=1e-9)
    assert int(si.eval_e(Q)[1].max()) == 0


@pytest.mark.parametrize("index", ["host", "device"])
def test_slice_at_scale_end_to_end_matches_jax(monkeypatch, index):
    # The at-scale path at a small size: a 1,000-site device build in
    # float64 past a lowered brute-force limit, so the facade builds its
    # cell index (on the host, or by the device build) and answers through
    # locate_cells and the walk.  Queries include out-of-square, cage and
    # out-of-cage points.
    rng = np.random.default_rng(9)
    sites = rng.uniform(-0.5, 0.5, size=(1000, 2))
    vals = np.sin(6 * sites[:, 0]) * np.cos(6 * sites[:, 1])
    ref = _jax_facade_at_scale(monkeypatch, sites, vals)
    if index == "device":
        monkeypatch.setattr(device_tri, "DEVICE_INDEX_MIN_TRIS", 8)
    si = ScatteredInterp(sites, vals, key=np.asarray(ref.shuffle), engine="device", device="cpu")
    monkeypatch.setattr(device_tri, "DENSE_LOCATE_MAX_TRIS", 8)
    Q = np.concatenate([
        rng.uniform(-0.5, 0.5, size=(3000, 2)),
        [[0.7, 0.0], [-3.0, 0.2], [1e7, 1e7]],
    ])
    walked = device_tri.locate.queries
    v = _same_surfaces(si, ref, Q)
    assert si._cells.complete == (index == "host")
    assert device_tri.locate.queries > walked  # the walk took the misses
    assert v[-1] == 0.0
    np.testing.assert_array_equal(si.tri.tri_verts.numpy(), np.asarray(ref.tri.tri_verts))


def test_3d_past_the_limit_waits_for_the_3d_index(monkeypatch):
    # The 3D index is here: past the limit the facade answers through it.
    rng = np.random.default_rng(4)
    si = ScatteredInterp(rng.uniform(-0.5, 0.5, size=(15, 3)), rng.normal(size=15),
                         engine="host", device="cpu")
    Q = si._queries(rng.uniform(-0.2, 0.2, size=(5, 3)))
    dense = device_tri.interp(si.tri, si.response, Q, method="dense")
    monkeypatch.setattr(device_tri, "DENSE_LOCATE_MAX_TRIS", 8)
    np.testing.assert_allclose(si.eval(Q).numpy(), dense.numpy(), rtol=0, atol=1e-9)
    assert si._cells is not None and si._cells.res == 8


@pytest.fixture
def one_torch_thread():
    """One torch intra-op thread for a 3D build: the test workers share the
    machine's cores, and eight threads per worker oversubscribe them many
    times over on its small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def facade_3d():
    """tests/test_scattered_api.py::test_3d_auto_cavity's problem at 200
    sites: the JAX facade (auto = cavity) and its insertion order."""
    rng = np.random.default_rng(1)
    sites = rng.uniform(-0.5, 0.5, size=(200, 3))
    vals = np.sin(3 * sites[:, 0]) * np.cos(2 * sites[:, 1]) + sites[:, 2]
    ref = JaxInterp(sites, vals, key=0, engine="auto")
    assert ref.engine == "cavity"
    Q = np.concatenate([
        rng.uniform(-0.5, 0.5, size=(800, 3)),
        [[0.7, 0.0, 0.1], [-3.0, 0.2, 0.0], [1e7, 1e7, 1e7]],
    ])
    return sites, vals, ref, Q


@pytest.mark.parametrize("engine", ["cavity", "auto"])
def test_3d_cavity_facade_matches_jax(facade_3d, one_torch_thread, engine):
    sites, vals, ref, Q = facade_3d
    si = ScatteredInterp(sites, vals, key=np.asarray(ref.shuffle), engine=engine, device="cpu")
    assert si.engine == "cavity" and si.tri.dtype == torch.float64
    assert {tuple(sorted(r)) for r in si.tri.tri_verts.tolist()} == {
        tuple(sorted(r)) for r in np.asarray(ref.tri.tri_verts).tolist()
    }
    v = _same_surfaces(si, ref, Q)
    assert v[-1] == 0.0
    _same_surfaces(si, ref, sites)  # at the vertices


def test_3d_cavity_lazy_index_matches_jax(monkeypatch, facade_3d, one_torch_thread):
    # Past a lowered brute-force limit both facades build their 3D cell
    # index (on the host below DEVICE_INDEX_MIN_TETS) at the first query.
    sites, vals, ref, Q = facade_3d
    monkeypatch.setattr(jdt, "DENSE_LOCATE_MAX_TRIS", 8)
    si = ScatteredInterp(sites, vals, key=np.asarray(ref.shuffle), engine="cavity", device="cpu")
    monkeypatch.setattr(device_tri, "DENSE_LOCATE_MAX_TRIS", 8)
    v = _same_surfaces(si, ref, Q)
    assert si._cells is not None and si._cells.complete and si._cells.k == 24
    dense = device_tri.interp(si.tri, si.response, si._queries(Q), method="dense")
    np.testing.assert_allclose(v.numpy(), dense.numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("engine,d", [("device", 2), ("cavity", 3)])
def test_accurate_dtype_is_float64(one_torch_thread, engine, d):
    # dtype="accurate" (JAX scattered.py:60-70) is float64 on every device,
    # with no change of engine: the result of dtype=torch.float64.
    rng = np.random.default_rng(6)
    sites = rng.uniform(-0.5, 0.5, size=(60, d))
    vals = np.cos(3 * sites[:, 0]) + sites[:, 1]
    a = ScatteredInterp(sites, vals, key=0, engine="auto", dtype="accurate", device="cpu")
    b = ScatteredInterp(sites, vals, key=0, engine="auto", dtype=torch.float64, device="cpu")
    assert a.engine == b.engine == engine
    assert a.tri.dtype == a.response.dtype == torch.float64
    Q = rng.uniform(-0.45, 0.45, size=(300, d))
    np.testing.assert_array_equal(a.eval(Q).numpy(), b.eval(Q).numpy())
