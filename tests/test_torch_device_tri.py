"""Port's query half (models/device_tri.py) vs the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import device_tri as jdt
from gsl_scattered_interpolation_tpu.models import host_tree as jht
from gsl_scattered_interpolation_tpu.utils import datasets, rng as jrng

from gsl_scattered_interpolation_torch.models import convert
from gsl_scattered_interpolation_torch.models import device_tri as dt
from gsl_scattered_interpolation_torch.models import host_tree as ht


def _fields(jtri):
    return {k: np.asarray(v) for k, v in jtri._asdict().items()}


@pytest.fixture(scope="module")
def weather():
    """Both packages' host build + freeze of the weather fixture, fed the
    same (JAX threefry) insertion permutation."""
    sites, temps = datasets.weather()
    perm = jrng.insertion_shuffle(0, len(sites))
    jtree = jht.build(sites, key=0)
    tree = ht.build(sites, key=perm)
    return {
        "sites": sites,
        "temps": temps,
        "jtri": jdt.freeze(jtree),
        "jresp": jdt.reindex_response(jtree, temps),
        "tri": dt.freeze(tree, device="cpu"),
        "resp": dt.reindex_response(tree, temps, device="cpu"),
    }


def _queries(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform([-89.5, 41.0], [-86.5, 43.1], size=(n, 2))


def test_freeze_matches_jax(weather):
    jf, tri = _fields(weather["jtri"]), weather["tri"]
    for name in ("points_raw", "points_std", "shift", "scale"):
        np.testing.assert_array_equal(getattr(tri, name).numpy(), jf[name])
    for name in ("tri_verts", "tri_nbrs", "grid_tri"):
        got = getattr(tri, name)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), jf[name])
    assert tri.grid_res == jf["grid_res"] == 64
    np.testing.assert_allclose(tri.affine.numpy(), jf["affine"], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(weather["resp"].numpy(), np.asarray(weather["jresp"]))


# d <= 3 use the closed-form adjugate on both sides; d = 4 goes through an
# LU solve, which is only good to about cond * eps on the cage slivers.
@pytest.mark.parametrize("d,rtol,atol", [(2, 0, 1e-12), (3, 0, 1e-12), (4, 1e-8, 1e-12)])
def test_affine_maps_match_jax(d, rtol, atol):
    rng = np.random.default_rng(d)
    sites = rng.uniform(-0.5, 0.5, size=(8 * d, d))
    jtri = jdt.freeze(jht.build(sites, flags=jht.NOSTANDARDIZE))
    raw, tv = np.array(jtri.points_raw), np.array(jtri.tri_verts)
    scale, shift = np.array(jtri.scale), np.array(jtri.shift)
    ours = dt.affine_maps(
        torch.as_tensor(raw), torch.as_tensor(tv),
        torch.as_tensor(scale), shift=torch.as_tensor(shift),
    )
    ref = np.asarray(jdt.affine_maps(jnp.asarray(raw), jnp.asarray(tv),
                                     jnp.asarray(scale), shift=jnp.asarray(shift)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=rtol, atol=atol)


# The circumsphere that the integrity checks use: d <= 3 in closed form on
# both sides (1e-12), d = 4 through an LU solve.
@pytest.mark.parametrize("d,rtol", [(2, 1e-12), (3, 1e-12), (4, 1e-8)])
def test_circumsphere_matches_jax(d, rtol):
    from gsl_scattered_interpolation_tpu.ops import geometry as jgeo
    from gsl_scattered_interpolation_torch.ops import geometry as geo

    rng = np.random.default_rng(10 + d)
    verts = rng.uniform(-0.5, 0.5, size=(200, d + 1, d))
    verts[0, 1] = verts[0, 0]  # one degenerate simplex
    c, r2, ok = geo.circumsphere(torch.as_tensor(verts))
    jc, jr2, jok = jgeo.circumsphere(jnp.asarray(verts))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert not ok[0] and ok[1:].all()
    np.testing.assert_allclose(c.numpy()[1:], np.asarray(jc)[1:], rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(r2.numpy()[1:], np.asarray(jr2)[1:], rtol=rtol, atol=1e-12)


def test_degenerate_simplex_is_poisoned():
    raw = torch.tensor([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [0.0, 1.0]])
    tv = torch.tensor([[0, 1, 2], [0, 1, 3]], dtype=torch.int32)
    aff = dt.affine_maps(raw.double(), tv, torch.ones(2, dtype=torch.float64))
    assert torch.all(aff[0, 6:] == -1e30) and torch.all(aff[0, :4] == 0)
    assert torch.isfinite(aff).all() and aff[1, 6:].max() == 1.0


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_locate_dense_matches_jax(weather, dtype):
    jtri, tri, Q = weather["jtri"], weather["tri"], _queries(1500, 5)
    if dtype == "f32":
        jtri, tri, Q = jtri.cast(jnp.float32), tri.cast(torch.float32), Q.astype(np.float32)
    jleaf, jw, jok = (np.asarray(a) for a in jdt.locate_dense(jtri, jnp.asarray(Q)))
    leaf, w, ok = dt.locate_dense(tri, torch.as_tensor(Q))
    np.testing.assert_array_equal(leaf.numpy(), jleaf)
    np.testing.assert_array_equal(ok.numpy(), jok)
    atol = 1e-12 if dtype == "f64" else 1e-5
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=atol)


@pytest.mark.parametrize("method", ["auto", "dense", "pallas"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_interp_matches_jax(weather, method, dtype):
    jtri, jresp = weather["jtri"], weather["jresp"]
    tri, resp = weather["tri"], weather["resp"]
    Q = _queries(1500, 7)
    if dtype == "f32":
        jtri, jresp = jtri.cast(jnp.float32), jresp.astype(jnp.float32)
        tri, resp = tri.cast(torch.float32), resp.float()
        Q = Q.astype(np.float32)
    jmethod = "dense" if method == "auto" else method  # JAX on the CPU
    kw = {"interpret": True} if jmethod == "pallas" else {}
    if kw:
        from gsl_scattered_interpolation_tpu.ops import pallas_locate as jpl

        leaf = jpl.locate_dense_pallas(jtri, jnp.asarray(Q), **kw)
        w = jdt._weights(jtri, leaf, jnp.asarray(Q))
        ref = np.asarray(jnp.sum(w * jresp[jtri.tri_verts[leaf]], axis=-1))
        ok = np.asarray(jnp.all(w >= -4.0 * np.sqrt(np.finfo(Q.dtype).eps), axis=-1))
        ref = np.where(ok, ref, 0.0)
    else:
        ref = np.asarray(jdt.interp(jtri, jresp, jnp.asarray(Q), method=jmethod))
    ours = dt.interp(tri, resp, torch.as_tensor(Q), method=method).numpy()
    # f64: the 1e-9 of tests/test_device_tri.py; f32: 1e-5 of the response scale
    atol = 1e-9 if dtype == "f64" else 1e-5 * float(np.abs(weather["temps"]).max())
    np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)


def test_resp_tri_and_out_of_cage(weather):
    tri, resp = weather["tri"], weather["resp"]
    Q = torch.as_tensor(np.concatenate([_queries(200, 9), [[1e7, 1e7]]]))
    rt = dt.vertex_responses(tri, resp)
    a = dt.interp(tri, resp, Q)
    np.testing.assert_array_equal(dt.interp(tri, None, Q, resp_tri=rt), a)
    assert a[-1] == 0.0
    np.testing.assert_allclose(
        dt.interp(tri, resp, torch.as_tensor(weather["sites"])).numpy(),
        weather["temps"], atol=1e-7,
    )


def test_interp_3d_matches_jax():
    rng = np.random.default_rng(3)
    sites = rng.uniform(-0.5, 0.5, size=(25, 3))
    vals = rng.normal(size=25)
    jtree = jht.build(sites, flags=jht.NOSTANDARDIZE)
    tree = ht.build(sites, flags=ht.NOSTANDARDIZE)
    Q = rng.uniform(-0.4, 0.4, size=(100, 3))
    ref = np.asarray(jdt.interp(jdt.freeze(jtree), jdt.reindex_response(jtree, vals), jnp.asarray(Q)))
    tri = dt.freeze(tree, device="cpu")
    ours = dt.interp(tri, dt.reindex_response(tree, vals, device="cpu"), torch.as_tensor(Q))
    assert tri.grid_res == jdt.freeze(jtree).grid_res
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-9)


def test_from_jax_arrays_round_trip(weather):
    fields = _fields(weather["jtri"])
    fields["response"] = np.asarray(weather["jresp"])
    tri, resp = convert.from_jax_arrays(fields, device="cpu")
    Q = _queries(300, 11)
    ref = np.asarray(jdt.interp(weather["jtri"], weather["jresp"], jnp.asarray(Q), method="dense"))
    np.testing.assert_allclose(
        dt.interp(tri, resp, torch.as_tensor(Q)).numpy(), ref, rtol=0, atol=1e-9
    )
    assert tri.to("cpu").cast(torch.float32).dtype == torch.float32
