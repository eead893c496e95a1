"""The port's 2D device build (models/device_delaunay.py) against the JAX
package's: whole builds row for row, one round from the same state, and the
checks of tests/test_device_delaunay.py that need no chunking."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import Delaunay as ScipyDelaunay

from gsl_scattered_interpolation_tpu.models import device_delaunay as jdd
from gsl_scattered_interpolation_tpu.models import host_tree as jht
from gsl_scattered_interpolation_tpu.ops import geometry as jgeometry
from gsl_scattered_interpolation_tpu.utils import datasets
from gsl_scattered_interpolation_tpu.utils import integrity as jintegrity
from gsl_scattered_interpolation_tpu.utils import rng as jrng

from gsl_scattered_interpolation_torch.models import convert, device_tri
from gsl_scattered_interpolation_torch.models import device_delaunay as dd
from gsl_scattered_interpolation_torch.utils import integrity

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
CASES = [("f64", n) for n in (1, 2, 5, 30, 200, 1000)] + [("f32", 30), ("f32", 300)]
_BUILDS = {}


def _rand(n, seed):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=(n, 2))


def _builds(dt, n):
    """(JAX build, port build) of the test's random sites, cached."""
    if (dt, n) not in _BUILDS:
        jdtype, dtype = DTYPES[dt]
        sites = _rand(n, n)
        ref = jdd.triangulate(sites, flags=jht.NOSTANDARDIZE, dtype=jdtype)
        ours = dd.triangulate(sites, flags=jht.NOSTANDARDIZE, dtype=dtype, device="cpu")
        _BUILDS[dt, n] = ref, ours
    return _BUILDS[dt, n]


def _assert_same_tri(ours, ref, atol=1e-12):
    """Row-equal ids; float fields within the f64 tolerance of
    tests/test_device_tri.py."""
    np.testing.assert_array_equal(ours.tri_verts.numpy(), np.asarray(ref.tri_verts))
    np.testing.assert_array_equal(ours.tri_nbrs.numpy(), np.asarray(ref.tri_nbrs))
    for f in ("points_raw", "points_std", "affine", "shift", "scale"):
        np.testing.assert_allclose(
            getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-12, atol=atol
        )
    assert ours.grid_res == ref.grid_res


@pytest.mark.parametrize("dt,n", CASES, ids=[f"{d}-{n}" for d, n in CASES])
def test_build_row_equal_to_jax(dt, n):
    (jtri, jshuffle), (tri, shuffle) = _builds(dt, n)
    np.testing.assert_array_equal(shuffle, np.asarray(jshuffle))
    assert tri.n_tris == 2 * n + 1  # Euler: the cage triangle split n times
    assert tri.dtype == torch.float64
    _assert_same_tri(tri, jtri)


@pytest.mark.parametrize("dt,n", CASES, ids=[f"{d}-{n}" for d, n in CASES])
def test_build_passes_integrity(dt, n):
    _, (tri, _) = _builds(dt, n)
    integrity.check_arrays(tri.points_std.numpy(), tri.tri_verts, tri.tri_nbrs, n_data=n)
    assert integrity.local_delaunay_violations(
        tri.points_std.numpy(), tri.tri_verts, tri.tri_nbrs
    ) == 0


def test_integrity_catches_what_jax_catches():
    # A quad with a non-Delaunay diagonal AB: D lies in circle(A, B, C).
    pts = np.array([[-9.0, -9.0], [9.0, -9.0], [0.0, 9.0],  # cage rows
                    [0.0, 0.0], [2.0, 0.0], [1.0, 1.0], [1.0, -0.2]])
    tv = np.array([[3, 4, 5], [3, 6, 4]], np.int32)
    tn = np.array([[-1, -1, 1], [-1, 0, -1]], np.int32)
    for check in (integrity.check_arrays, jintegrity.check_arrays):
        with pytest.raises(AssertionError, match="Delaunay violated"):
            check(pts, tv, tn, n_data=4)
    assert integrity.local_delaunay_violations(pts, tv, tn) == 2
    flipped_v = np.array([[5, 3, 6], [5, 6, 4]], np.int32)
    flipped_n = np.array([[-1, 1, -1], [-1, -1, 0]], np.int32)
    assert integrity.local_delaunay_violations(pts, flipped_v, flipped_n) == 0
    bad_n = tn.copy()
    bad_n[1, 1] = -1  # reverse link missing
    with pytest.raises(AssertionError, match="reverse link"):
        integrity.check_array_structure(tv, bad_n)
    with pytest.raises(AssertionError, match="reverse link"):
        jintegrity.check_arrays(pts, tv, bad_n, n_data=4)


def test_gridded_degenerate():
    # 5x5 lattice: cocircular quads everywhere (standardized, jittered).
    side = 5
    pts = np.stack(
        np.meshgrid(np.arange(side), np.arange(side), indexing="ij"), axis=-1
    ).reshape(-1, 2).astype(float)
    jtri, _ = jdd.triangulate(pts)
    tri, _ = dd.triangulate(pts, device="cpu")
    integrity.check_arrays(tri.points_std.numpy(), tri.tri_verts, tri.tri_nbrs, n_data=len(pts))
    _assert_same_tri(tri, jtri)


def test_weather_end_to_end():
    sites, temps = datasets.weather()
    perm = np.asarray(jrng.insertion_shuffle(0, len(sites)))
    jtri, jshuffle = jdd.triangulate(sites, key=0)
    tri, shuffle = dd.triangulate(sites, key=perm, device="cpu")
    np.testing.assert_array_equal(shuffle, np.asarray(jshuffle))
    _assert_same_tri(tri, jtri)
    integrity.check_arrays(tri.points_std.numpy(), tri.tri_verts, tri.tri_nbrs, n_data=50)
    resp = device_tri.response_for_build(shuffle, temps, device="cpu")
    np.testing.assert_array_equal(
        resp.numpy(), np.asarray(jnp.concatenate([jnp.zeros(3), jnp.asarray(temps)[jshuffle]]))
    )
    # Interpolation at the sites reproduces the responses.
    vals = device_tri.interp(tri, resp, torch.as_tensor(sites)).numpy()
    np.testing.assert_allclose(vals, temps, atol=1e-7)


def test_interior_subset_of_scipy():
    sites = _rand(500, 7)
    tri, shuffle = dd.triangulate(sites, flags=jht.NOSTANDARDIZE, device="cpu")
    scipy_set = {tuple(sorted(s)) for s in ScipyDelaunay(sites).simplices.tolist()}
    ours = {
        tuple(sorted(int(shuffle[v - 3]) for v in row))
        for row in tri.tri_verts.numpy() if (row > 2).all()
    }
    assert ours <= scipy_set
    assert len(ours) >= 0.8 * len(scipy_set)


# The JAX rounds run jitted.  On these states the jitted and the op-by-op
# JAX rounds give the same arrays in float32 and float64, and the port
# rounds op by op.
_split = jax.jit(jdd._split_round)
_flips = jax.jit(jdd._flip_rounds, static_argnums=2)
_flip = jax.jit(jdd._flip_round)


def _jax_mid_state(dtype, n=400, seed=3):
    """A few JAX build rounds (the fixture of tests/test_pallas_candmath.py);
    both packages then start from it."""
    sites = np.random.default_rng(seed).uniform(-0.5, 0.5, size=(n, 2))
    cage = jgeometry.cage_vertices(2, np.zeros(2), np.ones(2), np.float64)
    pts = jnp.asarray(np.concatenate([cage, sites]), dtype)
    st = jdd._init_state(pts, n, jnp.int32(n), cap=2 * n + 3)
    for _ in range(4):
        st = _split(pts, st)
        st, _ = _flips(pts, st, 2)
    return pts, st


def _assert_same_state(ours, ref):
    M = ref.tri_v.shape[0]
    for f in ("tri_v", "tri_n", "cc"):
        np.testing.assert_array_equal(getattr(ours, f)[:M].numpy(), np.asarray(getattr(ref, f)))
    np.testing.assert_array_equal(ours.site_tri.numpy(), np.asarray(ref.site_tri))
    assert int(ours.n_left) == int(ref.n_left) and int(ours.n_tris) == int(ref.n_tris)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_one_round_from_the_same_state(dt):
    jdtype, dtype = DTYPES[dt]
    pts, st = _jax_mid_state(jdtype)
    tpts = torch.tensor(np.asarray(pts))
    ours = convert.from_jax_build_state(
        {k: np.asarray(v) for k, v in st._asdict().items()}, device="cpu"
    )
    _assert_same_state(ours, st)

    # One split round.
    ref_split = _split(pts, st)
    our_split = dd._split_round(tpts, ours)
    _assert_same_state(our_split, ref_split)

    # The candidate pass on the split state.
    M = st.tri_v.shape[0]
    jtv, jtn, jcand = jdd._edge_candidates(
        pts, ref_split.tri_v, ref_split.tri_n, ref_split.cc,
        jnp.arange(M, dtype=jnp.int32), jnp.ones(M, bool),
    )
    tv, tn, cand = dd._edge_candidates(
        tpts, our_split.tri_v, our_split.tri_n, our_split.cc,
        torch.arange(M, dtype=torch.int32), torch.ones(M, dtype=torch.bool),
    )
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jtv))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jtn))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    assert int(cand.sum()) > 0

    # One flip sub-round, with site relocation.
    carry = (*ref_split[:5], True)
    jv, jn, jcc, jnt, jsite, jany = _flip(pts, carry)
    ref_flip = jdd.BuildState(jv, jn, jcc, jnt, jsite, ref_split.n_left)
    our_flip, any_flip = dd._flip_round(tpts, our_split)
    _assert_same_state(our_flip, ref_flip)
    assert bool(any_flip) == bool(jany) is True


def test_limits_raise():
    # Past the chunk threshold the chunked route builds; the vertex-id sums'
    # float32 limit, 3(n + 3) < 2^24, and d != 2 still raise.
    tri, _ = dd.triangulate(_rand(50, 0), device="cpu", chunk_threshold=20)
    assert tri.n_tris == 101
    with pytest.raises(NotImplementedError, match="inexact in float32"):
        dd.triangulate(np.zeros((2**24 // 3 - 2, 2)), device="cpu")
    with pytest.raises(NotImplementedError, match="2D"):
        dd.triangulate(np.zeros((5, 3)), device="cpu")
