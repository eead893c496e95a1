"""The port's cavity build (models/device_cavity.py) against the JAX
package's: the predicates and one call of _grow_cavities and _round from
the same state, row for row; and the port's own checks of the build (the
2D build against the flip engine, the limits, the seed repair).  Whole
builds against the JAX package's are in tests/test_torch_cavity_builds.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import device_cavity as jdc
from gsl_scattered_interpolation_tpu.models import host_tree as jht

from gsl_scattered_interpolation_torch.models import convert
from gsl_scattered_interpolation_torch.models import device_cavity as dc
from gsl_scattered_interpolation_torch.models import device_delaunay as dd
from gsl_scattered_interpolation_torch.utils import errors

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores, and eight threads per worker oversubscribe them many times over
    on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(n, d, seed):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=(n, d))


def _canon(tv, shuffle, d):
    """The simplex set in user row ids (cage ids stay 0..d)."""
    inv = np.concatenate([np.arange(d + 1), np.asarray(shuffle) + d + 1])
    return {tuple(sorted(r)) for r in inv[np.asarray(tv)].tolist()}


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_cavity_predicates_equal_jax(d, dt):
    jdtype, dtype = DTYPES[dt]
    rng = np.random.default_rng(10 + d)
    P = rng.uniform(-0.5, 0.5, size=(600, d + 2, d))
    P[:200, 0] *= 80.0  # a cage-scale vertex
    t = np.linspace(-1, 1, 200)[:, None]  # near-cospherical / flat rows
    P[200:400, -1] = P[200:400, 0] + t * (P[200:400, 1] - P[200:400, 0]) + 1e-9
    P[400:, d] = P[400:, 0]  # exactly degenerate simplexes
    P = P.astype(np.dtype(jdtype))
    verts, q = torch.from_numpy(P[:, : d + 1].copy()), torch.from_numpy(P[:, d + 1].copy())
    jverts, jq = jnp.asarray(P[:, : d + 1]), jnp.asarray(P[:, d + 1])
    insphere, minw = dc._insphere(d), dc._minw(d)
    jins = {2: jdc._insphere_robust2d, 3: jdc._insphere_robust3d}.get(d, jdc._insphere_robust_nd)
    jminw = {2: jdc._minw_robust2d, 3: jdc._minw_robust3d}.get(d, jdc._minw_robust_nd)
    np.testing.assert_array_equal(insphere(verts, q).numpy(), np.asarray(jins(jverts, jq)))
    w, jw = minw(verts, q).numpy(), np.asarray(jminw(jverts, jq))
    assert w.dtype == jw.dtype
    np.testing.assert_array_equal(w, jw)
    assert np.isneginf(w[400:]).all()
    # The plain determinant reaches the same verdicts on well-conditioned
    # rows (tests/test_robust.py), and equals JAX's in float64.
    plain = dc._insphere_det(verts[200:400].double(), q[200:400].double())
    np.testing.assert_array_equal(
        plain.numpy(),
        np.asarray(jdc._insphere_det(jverts[200:400].astype(jnp.float64),
                                     jq[200:400].astype(jnp.float64))),
    )
    np.testing.assert_array_equal(plain.numpy(), insphere(verts[200:400].double(), q[200:400].double()).numpy())


# ---------------------------------------------------------------------------
# Row-equal: one call from one state
# ---------------------------------------------------------------------------


def _round_case(dt, n=400, n_seed=150):
    """A 3D build in the build dtype, started from scipy's Delaunay
    triangulation of the cage and the first ``n_seed`` sites: pts [P, 3]
    numpy and the seeded state's fields (numpy)."""
    from scipy.spatial import Delaunay

    jdtype, dtype = DTYPES[dt]
    ulps = 0.0 if dt == "f32" else float(1 << 16)
    *_, cage, sites = dd.build_inputs(
        _rand(n, 3, 7), flags=jht.NOSTANDARDIZE, dtype=dtype, jitter_ulps=ulps
    )
    pts = np.concatenate([cage.numpy(), sites.astype(np.dtype(jdtype))])
    sd = Delaunay(pts[: 4 + n_seed].astype(np.float64))
    loc = sd.find_simplex(pts[4 + n_seed :].astype(np.float64))
    site_tri = np.concatenate([np.full(n_seed, -1), loc]).astype(np.int32)
    assert (loc >= 0).all()
    M = int(9.0 * n) + 64
    tri_v = np.full((M, 4), -1, np.int32)
    tri_n = np.full((M, 4), -1, np.int32)
    T = sd.simplices.shape[0]
    tri_v[:T], tri_n[:T] = sd.simplices, sd.neighbors
    return pts, dict(tri_v=tri_v, tri_n=tri_n, n_tris=np.int32(T),
                     site_tri=site_tri, n_left=np.int32(n - n_seed))


# (s_div, waves): a small s_div fills many candidate rows.
ROUND_CFG = {"f64": (4, 2), "f32": (8, 4)}


@functools.lru_cache(maxsize=None)
def _jax_rounds(dt, k=8):
    """k successive JAX round states (numpy) from the seeded state, with
    S = 256 and C = 32, and each round's winner count."""
    s_div, waves = ROUND_CFG[dt]
    pts, st0 = _round_case(dt)
    pts = jnp.asarray(pts)
    st = jdc.CavityState(**{k_: jnp.asarray(v) for k_, v in st0.items()})
    step = jax.jit(lambda p, s: jdc._round(p, s, 256, 32, s_div=s_div, waves=waves))
    states, wins = [st0], []
    for _ in range(k):
        st, n_w = step(pts, st)
        states.append({k_: np.asarray(v) for k_, v in st._asdict().items()})
        wins.append(int(n_w))
    return states, wins


def _state_equal(st, ref):
    M = ref["tri_v"].shape[0]
    np.testing.assert_array_equal(st.tri_v[:M].numpy(), ref["tri_v"])
    np.testing.assert_array_equal(st.tri_n[:M].numpy(), ref["tri_n"])
    np.testing.assert_array_equal(st.site_tri.numpy(), ref["site_tri"])
    assert int(st.n_tris) == int(ref["n_tris"]) and int(st.n_left) == int(ref["n_left"])


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_round_equals_jax(dt):
    s_div, waves = ROUND_CFG[dt]
    pts = torch.from_numpy(_round_case(dt)[0])
    states, wins = _jax_rounds(dt)
    assert sum(wins) > 40 and min(wins) > 3  # conflicts and relocations
    for i in range(len(wins)):
        st = convert.from_jax_cavity_state(states[i], device="cpu")
        n_tris = int(st.n_tris)
        for rows in (None, min(max(n_tris // s_div, 4), 256)):
            out, n_w = dc._round(pts, st, 256, 32, s_div=s_div, waves=waves, rows=rows)
            assert int(n_w) == wins[i]
            _state_equal(out, states[i + 1])
        # _round leaves its input state as it was.
        _state_equal(st, states[i])


def _candidates(st, S, d):
    """The first S claims of a numpy state: (cand_tri, active, q ids)."""
    site_tri = st["site_tri"]
    M = st["tri_v"].shape[0]
    claim = np.full(M, np.iinfo(np.int32).max)
    np.minimum.at(claim, np.where(site_tri >= 0, site_tri, 0), np.where(site_tri >= 0, np.arange(len(site_tri)), claim[0]))
    tris = np.nonzero(claim < len(site_tri))[0][:S]
    cand_tri = np.full(S, -1, np.int32)
    cand_tri[: len(tris)] = tris
    spid = np.zeros(S, np.int64)
    spid[: len(tris)] = claim[tris] + d + 1
    return cand_tri, cand_tri >= 0, spid


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("C", [8, 32])
def test_grow_cavities_equals_jax(dt, C):
    # C = 8 overflows more cavities than C = 32.
    states, _ = _jax_rounds(dt)
    ref = states[-1]
    pts = _round_case(dt)[0]
    cand_tri, active, spid = _candidates(ref, 256, 3)
    grow = jax.jit(jdc._grow_cavities, static_argnums=(5,))
    jcav, jn, jov = grow(
        jnp.asarray(pts), jdc.CavityState(**{k: jnp.asarray(v) for k, v in ref.items()}),
        jnp.asarray(pts[spid]), jnp.asarray(cand_tri), jnp.asarray(active), C,
    )
    st = convert.from_jax_cavity_state(ref, device="cpu")
    cav, n_cav, ov = dc._grow_cavities(
        torch.from_numpy(pts), st, torch.from_numpy(pts[spid]),
        torch.from_numpy(cand_tri), torch.from_numpy(active), C,
    )
    np.testing.assert_array_equal(cav.numpy(), np.asarray(jcav))
    np.testing.assert_array_equal(n_cav.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
    assert ov.any() and n_cav.max() > 4  # some cavities overflow at both C


def test_2d_cavity_equals_flip_engine():
    # tests/test_device_cavity.py::TestCavity2D::test_matches_flip_engine,
    # within the port: no JAX build is needed.
    sites = _rand(300, 2, 7)
    t1, s1 = dc.triangulate(sites, flags=jht.NOSTANDARDIZE, device="cpu")
    t2, s2 = dd.triangulate(sites, flags=jht.NOSTANDARDIZE, device="cpu")
    assert t1.n_tris == 2 * 300 + 1
    assert _canon(t1.tri_verts.numpy(), s1, 2) == _canon(t2.tri_verts.numpy(), s2, 2)


def test_capacity_and_cavity_limits_raise(monkeypatch):
    sites = _rand(40, 3, 3)
    with pytest.raises(errors.CapacityError, match="slots_per_site"):
        dc.triangulate(sites, flags=jht.NOSTANDARDIZE, device="cpu", slots_per_site=1.0)
    # Rounds that never win escalate C past MAX_CAVITY.
    monkeypatch.setattr(dc, "_round", lambda pts, st, *a, **k: (st, torch.tensor(0)))
    *_, cage, std = dd.build_inputs(sites, flags=jht.NOSTANDARDIZE)
    with pytest.raises(RuntimeError, match="exceed 4096"):
        dc.build(torch.from_numpy(std), cage, cavity_cap=1024, slots_per_site=500.0)


def test_seed_that_is_not_delaunay_is_repaired():
    # With the float64 cage, Qhull's seed of these sites is not Delaunay at
    # 5 points; the JAX package imports it as it is.  The port leaves their
    # sites out of the seed, and the build is Delaunay everywhere and
    # agrees with scipy.
    from scipy.interpolate import LinearNDInterpolator

    sites = _rand(3000, 3, 5)
    *_, cage, sb = dd.build_inputs(
        sites, flags=jht.NOSTANDARDIZE, dtype=torch.float64, jitter_ulps=float(1 << 16)
    )
    pts = torch.cat([cage, torch.from_numpy(sb)])
    tets0, nbrs0, _, _ = dc._qhull_seed(sb, cage, torch.float64, None)
    assert dc._seed_violations(pts, tets0, nbrs0).numel() == 5
    stats = {}
    tri, sh = dc.triangulate(sites, flags=jht.NOSTANDARDIZE, device="cpu", seed_min=64, stats=stats)
    assert stats["seeded"] and 0 < stats["seed_left_out"] < 20
    assert stats["seed_sites"] == 2400 - stats["seed_left_out"]
    assert dc._seed_violations(pts, tri.tri_verts.numpy(), tri.tri_nbrs.numpy()).numel() == 0
    vals = np.sin(3 * sites[:, 0]) + sites[:, 1] * sites[:, 2]
    q = _rand(4000, 3, 6) * 0.9
    resp = torch.as_tensor(np.concatenate([np.zeros(4), vals]))
    from gsl_scattered_interpolation_torch.models import device_tri as dt

    out = dt.interp(tri, resp, torch.as_tensor(q), method="walk").numpy()
    ref = LinearNDInterpolator(sites, vals)(q)
    inside = np.isfinite(ref)
    assert inside.mean() > 0.99
    np.testing.assert_allclose(out[inside], ref[inside], rtol=0, atol=1e-9)
