"""The port's chunked, Qhull-seeded 2D build (models/device_delaunay.py)
against the JAX package's: one call of each module from the same state,
row for row, and whole builds as sets of alive triangles, as in
tests/test_device_delaunay.py."""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import Delaunay as ScipyDelaunay

from gsl_scattered_interpolation_tpu.models import device_delaunay as jdd
from gsl_scattered_interpolation_tpu.models import device_tri as jdt
from gsl_scattered_interpolation_tpu.models import host_tree as jht
from gsl_scattered_interpolation_tpu.ops import geometry as jgeometry

from gsl_scattered_interpolation_torch import ScatteredInterp
from gsl_scattered_interpolation_torch.models import convert, device_tri
from gsl_scattered_interpolation_torch.models import device_delaunay as dd
from gsl_scattered_interpolation_torch.utils import integrity

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}


def _rand(n, seed):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=(n, 2))


def _lattice(side=40):
    return np.stack(
        np.meshgrid(np.arange(side), np.arange(side), indexing="ij"), axis=-1
    ).reshape(-1, 2).astype(float)


def _cage(dt):
    """The unit cage in the build dtype: (numpy float64, port tensor)."""
    np_dtype = np.float64 if dt == "f64" else np.float32
    cage = jgeometry.cage_vertices(2, np.zeros(2), np.ones(2), np_dtype)
    return np.asarray(cage, np.float64), torch.tensor(np.asarray(cage), dtype=DTYPES[dt][1])


def _alive_set(tv, alive=None):
    tv = np.asarray(tv)
    if alive is not None:
        tv = tv[np.asarray(alive)]
    return {tuple(sorted(r)) for r in tv.tolist()}


# ---------------------------------------------------------------------------
# Row-equal: one call from one state
# ---------------------------------------------------------------------------

_jwalk = jax.jit(jdd._locate_walk_exact, static_argnames=("max_steps", "lockstep", "tail_div"))


def _walk_case(dt):
    """A Qhull triangulation of the cage and 400 sites, and 1,200 sites to
    locate in it, in both packages."""
    jdtype, dtype = DTYPES[dt]
    cage, _ = _cage(dt)
    sites = _rand(1200, 21)
    pts = np.concatenate([cage, sites]).astype(np.dtype(jdtype)).astype(np.float64)
    sd = ScipyDelaunay(pts[:403])
    tv, tn = sd.simplices.astype(np.int32), sd.neighbors.astype(np.int32)
    start = np.random.default_rng(2).integers(0, tv.shape[0], 1200).astype(np.int32)
    return pts, tv, tn, start


# (max_steps, lockstep, tail_div): every query located; the tail
# workspace overflows; the step budget runs out.
WALKS = {"located": (256, 8, 1), "overflow": (256, 8, 16), "budget": (12, 4, 1)}


@pytest.mark.parametrize("dt,case", [("f64", c) for c in WALKS] + [("f32", "located")])
def test_walk_exact_equals_jax(dt, case):
    jdtype, dtype = DTYPES[dt]
    pts, tv, tn, start = _walk_case(dt)
    jpts = jnp.asarray(pts, jdtype)
    jpacked = jdd._pack_walk_rows(jpts, jnp.asarray(tv), jnp.asarray(tn))
    tpts = torch.tensor(pts, dtype=dtype)
    packed = dd._pack_walk_rows(tpts, torch.tensor(tv), torch.tensor(tn))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))

    max_steps, lockstep, tail_div = WALKS[case]
    kw = dict(max_steps=max_steps, lockstep=lockstep, tail_div=tail_div)
    jleaf, jok = _jwalk(jpacked, jnp.asarray(start), jpts[3:], **kw)
    leaf, ok = dd._locate_walk_exact(packed, torch.tensor(start), tpts[3:], **kw)
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    n_bad = int((~ok).sum())
    assert (n_bad == 0) == (case == "located"), n_bad
    if case == "located":  # the sites past the seed's, as scipy locates them
        want = ScipyDelaunay(pts[:403]).find_simplex(pts[403:])
        assert (want == leaf.numpy()[400:]).mean() > 0.99


def _jax_seed(dt, n=1024, seed_frac=2):
    """The JAX seed state of the sites of tests/test_device_delaunay.py's
    seed test, as numpy arrays."""
    jdtype, _ = DTYPES[dt]
    sites = _rand(n, 5)
    cage, _ = _cage(dt)
    pts, st, dirty = jdd._seed_state_2d(sites, cage, n, jdtype, seed_frac=seed_frac)
    return sites, {
        "pts": np.asarray(pts), "dirty": np.asarray(dirty),
        **{k: np.asarray(v) for k, v in st._asdict().items()},
    }


@functools.lru_cache(maxsize=None)
def _seeds(dt):
    return _jax_seed(dt)


def _port_state(ref):
    """The port's (pts, BuildState, dirty) from JAX arrays."""
    st = convert.from_jax_build_state(ref, device="cpu")
    dirty = torch.cat([torch.tensor(ref["dirty"]), torch.zeros(1, dtype=torch.bool)])
    return torch.tensor(ref["pts"]), st, dirty


def _assert_same_state(st, dirty, ref):
    M = ref["tri_v"].shape[0]
    for f in ("tri_v", "tri_n", "cc"):
        np.testing.assert_array_equal(getattr(st, f)[:M].numpy(), ref[f], err_msg=f)
    np.testing.assert_array_equal(st.site_tri.numpy(), ref["site_tri"])
    np.testing.assert_array_equal(dirty[:M].numpy(), ref["dirty"])
    assert int(st.n_tris) == int(ref["n_tris"]) and int(st.n_left) == int(ref["n_left"])


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_seed_state_equals_jax(dt):
    sites, ref = _seeds(dt)
    _, cage = _cage(dt)
    pts, st, dirty = dd._seed_state_2d(sites, cage, seed_frac=2)
    np.testing.assert_array_equal(pts.numpy(), ref["pts"])
    _assert_same_state(st, dirty, ref)
    # The f64 seed starts dirty (its jitter lies inside Qhull's merge
    # tolerance), the f32 seed clean.
    T0 = int(st.n_tris)
    d0 = dirty.numpy()
    if dt == "f64":
        assert d0[:T0].all() and not d0[T0:].any()
    else:
        assert not d0.any()
    assert int(st.n_left) == int((st.site_tri >= 0).sum()) > 0


_jsplit = jax.jit(jdd._split_round_compact, static_argnums=(3, 4))


def _jax_state(ref):
    pts = jnp.asarray(ref["pts"])
    st = jdd.BuildState(*(jnp.asarray(ref[f]) for f in jdd.BuildState._fields))
    return pts, st, jnp.asarray(ref["dirty"])


def _as_ref(pts, st, dirty, **extra):
    return {"pts": np.asarray(pts), "dirty": np.asarray(dirty),
            **{k: np.asarray(v) for k, v in st._asdict().items()}, **extra}


# (R, r_site): R = 600 puts the block start at min(n_tris, M - 2R) < n_tris
# (M = 2,051, n_tris = 1,025) and relocates the compacted sites at once;
# R = 64 defers claims and relocates 100 sites at a time.
SPLITS = [("f64", 600, 1 << 21), ("f64", 64, 100), ("f32", 600, 1 << 21)]


@functools.lru_cache(maxsize=None)
def _jax_split(dt, R, r_site):
    _, ref = _seeds(dt)
    jpts, jst, jdirty = _jax_state(ref)
    st, dirty, n_new = _jsplit(jpts, jst, jdirty, R, r_site)
    return _as_ref(jpts, st, dirty, n_new=int(n_new))


@pytest.mark.parametrize("dt,R,r_site", SPLITS)
def test_split_round_compact_equals_jax(dt, R, r_site):
    _, ref = _seeds(dt)
    pts, st, dirty = _port_state(ref)
    M = st.tri_v.shape[0] - 1
    assert int(st.n_tris) > M - 2 * R or R == 64
    want = _jax_split(dt, R, r_site)
    st2, dirty2, n_new = dd._split_round_compact(pts, st, dirty, R, r_site)
    _assert_same_state(st2, dirty2, want)
    assert int(n_new) == want["n_new"] > 0
    if R == 64:  # the claims past R wait
        assert want["n_new"] == 64 and int(st2.n_left) == int(st.n_left) - 64


_jsweep = jax.jit(jdd._flip_sweep_compact, static_argnames=("R", "r_site", "rf_div"))


# (R, cap, relocate, rf_div): the insert phase's sweep with relocation on
# a workspace smaller than the dirty set, and the final sweep's.
SWEEPS = [("f64", 200, 3, True, 4), ("f64", 512, 4, False, 2), ("f32", 200, 3, True, 4)]


@pytest.mark.parametrize("dt,R,cap,relocate,rf_div", SWEEPS)
def test_flip_sweep_compact_equals_jax(dt, R, cap, relocate, rf_div):
    ref = _jax_split(dt, 600, 1 << 21)
    jpts, jst, jdirty = _jax_state(ref)
    out = _jsweep(jpts, jst.tri_v, jst.tri_n, jst.cc, jdirty, R=R, cap=jnp.int32(cap),
                  site_tri=jst.site_tri if relocate else None, r_site=1 << 21, rf_div=rf_div)
    jv, jn, jcc, jdirty2, jused, jnd, jsite, jnf, jnc = out
    pts, st, dirty = _port_state(ref)
    M = st.tri_v.shape[0] - 1
    assert int(dirty[:M].sum()) > R  # rows overflow the workspace
    tv, tn, cc, dirty2, used, nd, site, nf, nc = dd._flip_sweep_compact(
        pts, st.tri_v, st.tri_n, st.cc, dirty, R, cap,
        site_tri=st.site_tri if relocate else None, r_site=1 << 21, rf_div=rf_div,
    )
    for ours, theirs in ((tv, jv), (tn, jn), (cc, jcc), (dirty2, jdirty2)):
        np.testing.assert_array_equal(ours[:M].numpy(), np.asarray(theirs))
    if relocate:
        np.testing.assert_array_equal(site.numpy(), np.asarray(jsite))
    assert (used, nd, nf, nc) == (int(jused), int(jnd), int(jnf), int(jnc))
    assert used == cap and nf > 0


def _relocate_case(n=5000, T=3000):
    """Sites, their triangles and a random relocation record [T, 6]."""
    rng = np.random.default_rng(9)
    sites = _rand(n, 8)
    pts = np.concatenate([np.zeros((3, 2)), sites])
    site_tri = rng.integers(0, T, n).astype(np.int32)
    e, c = rng.uniform(-0.5, 0.5, (T, 2)), rng.uniform(-0.5, 0.5, (T, 2))
    sg = rng.choice([-1.0, 1.0], T)
    partner = np.where(rng.random(T) < 0.7, rng.integers(0, T, T), -1)
    frec = np.concatenate([e, c, sg[:, None], partner[:, None]], -1)
    return pts, site_tri, frec, rng


@functools.lru_cache(maxsize=None)
def _jax_relocate(r_site):
    def run(pts, site_tri, affected, frec):
        return jdd._relocate_sites_chunked(
            pts, site_tri, affected, lambda t, q: jdd._assign_flip_side_rec(frec, t, q), r_site
        )

    return jax.jit(run)


# Each of JAX's branches against the port's one compacted route: JAX's
# compact branch (500 affected <= max(1024, N // 4)), its dense branch
# (4,000 affected), and its chunk loop (3 * r_site < 2N).
RELOCATES = [(500, 1 << 21), (4000, 1 << 21), (4000, 1000)]


@pytest.mark.parametrize("cnt,r_site", RELOCATES)
def test_relocate_routes_equal_jax(cnt, r_site):
    pts, site_tri, frec, rng = _relocate_case()
    n = site_tri.shape[0]
    affected = np.zeros(n, bool)
    affected[rng.choice(n, cnt, replace=False)] = True
    want = np.asarray(_jax_relocate(r_site)(
        jnp.asarray(pts), jnp.asarray(site_tri), jnp.asarray(affected), jnp.asarray(frec)
    ))
    assert (want != site_tri).sum() > cnt // 10  # the record moves sites
    tpts, tsite, taff, tfrec = (torch.tensor(a) for a in (pts, site_tri, affected, frec))

    def decide(t, q):
        return dd._assign_flip_side_rec(tfrec, t, q)

    # The port's one route, in JAX's r_site chunks and in chunks of 333.
    routes = {
        "r_site": dd._relocate_sites_chunked(tpts, tsite, taff, decide, r_site),
        "chunks_of_333": dd._relocate_sites_chunked(tpts, tsite, taff, decide, 333),
    }
    for name, got in routes.items():
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


# ---------------------------------------------------------------------------
# Set-equal: whole builds
# ---------------------------------------------------------------------------

_BUILDS = {}

# name: (sites, JAX triangulate's keywords, the port's).  The lattice's
# reference is JAX's single-program build (JAX's own lattice test seeds).
BUILDS = {
    "chunked_700": (_rand(700, 11), dict(flags=jht.NOSTANDARDIZE, chunk_threshold=100), {}),
    "seeded_3000": (_rand(3000, 17), dict(flags=jht.NOSTANDARDIZE, chunk_threshold=1000,
                                          seed_min=1000), {}),
    "lattice": (_lattice(), {}, dict(chunk_threshold=500, seed_min=500)),
}


@pytest.fixture(scope="module")
def jax_builds():
    """JAX ``triangulate`` of each case, made once per module on first use."""

    def get(name):
        if name not in _BUILDS:
            sites, jkw, _ = BUILDS[name]
            _BUILDS[name] = jdd.triangulate(sites, **jkw)
        return _BUILDS[name]

    return get


def _port_build(name, stats=None):
    sites, jkw, kw = BUILDS[name]
    return dd.triangulate(sites, device="cpu", stats=stats, **{**jkw, **kw})


def _check_integrity(tri, n):
    integrity.check_arrays(tri.points_std.numpy(), tri.tri_verts, tri.tri_nbrs, n_data=n)


@pytest.mark.parametrize("name", ["chunked_700", "seeded_3000", "lattice"])
def test_build_set_equal_to_jax(jax_builds, name):
    jtri, jshuffle = jax_builds(name)
    stats = {}
    tri, shuffle = _port_build(name, stats)
    np.testing.assert_array_equal(shuffle, np.asarray(jshuffle))
    n = shuffle.shape[0]
    assert tri.n_tris == 2 * n + 1
    assert _alive_set(tri.tri_verts) == _alive_set(jtri.tri_verts)
    _check_integrity(tri, n)
    # The lattice seeds: the port's seed holds its first 200 sites.  (JAX's
    # seeded lattice build seeds from its padded bucket's 256, and its walk
    # gives up on some site, so JAX builds that lattice without a seed.)
    assert stats["seeded"] == (name != "chunked_700")
    assert stats["insert_iterations"] > 0 and stats["final_sweep_rounds"] > 0


def test_forced_overflow_set_equal_to_jax(jax_builds):
    # r_compact = 96: every sweep round overflows its workspace.  tail_floor
    # 0 keeps the big rung (4 split and 2 flip rounds per iteration) to the
    # end; r_site 64 relocates in chunks.  The sites and the reference are
    # those of the 700-site chunked case (no shuffle, NOSTANDARDIZE: the
    # build's point ids are triangulate's).
    jtri, _ = jax_builds("chunked_700")
    want = _alive_set(jtri.tri_verts)
    *_, cage, std = dd.build_inputs(BUILDS["chunked_700"][0], flags=jht.NOSTANDARDIZE)
    for kw in (dict(r_compact=96), dict(r_compact=96, tail_floor=0, r_site=64)):
        stats = {}
        tv, _, alive, n_tris = dd.build_2d_chunked(torch.tensor(std), cage, stats=stats, **kw)
        assert _alive_set(tv, alive) == want, kw
        assert int(n_tris) == int(alive.sum()) == 1401
        assert stats["split_rounds"] > stats["insert_iterations"] or "tail_floor" not in kw


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_chunked_route_equals_single_route(dt):
    # The port's two routes on the same sites, without and with a seed,
    # with the big rung, chunked relocation and overflowing workspaces.
    _, dtype = DTYPES[dt]
    sites = _rand(1500, 31)
    ref, _ = dd.triangulate(sites, flags=jht.NOSTANDARDIZE, dtype=dtype, device="cpu")
    want = _alive_set(ref.tri_verts)
    *_, cage, std = dd.build_inputs(sites, flags=jht.NOSTANDARDIZE, dtype=dtype)
    seed = dd._seed_state_2d(std, cage)
    assert seed is not None
    tstd = torch.tensor(std, dtype=dtype)
    for s in (None, seed):
        tv, _, alive, n_tris = dd.build_2d_chunked(
            tstd, cage, seed=s, r_compact=256, tail_floor=16, r_site=500
        )
        assert _alive_set(tv, alive) == want
        assert int(n_tris) == int(alive.sum()) == 3001


def test_seed_walk_failure_builds_without_seed(monkeypatch, caplog):
    # A walk with no budget leaves sites unlocated: the build logs a
    # warning and runs without a seed, to the same triangulation.
    walk = dd._locate_walk_exact
    monkeypatch.setattr(dd, "_locate_walk_exact",
                        lambda *a: walk(*a, max_steps=1, lockstep=1))
    sites = _rand(800, 3)
    stats = {}
    with caplog.at_level(logging.WARNING, logger=dd.__name__):
        tri, _ = dd.triangulate(sites, device="cpu", chunk_threshold=100, seed_min=100,
                                stats=stats)
    assert stats["seeded"] is False
    assert "building without a seed" in caplog.text
    ref, _ = dd.triangulate(sites, device="cpu")
    assert _alive_set(tri.tri_verts) == _alive_set(ref.tri_verts)


# ---------------------------------------------------------------------------
# The device walk-start grid and the slice end to end
# ---------------------------------------------------------------------------


def test_device_grid_equals_jax_and_host(jax_builds):
    jtri, _ = jax_builds("seeded_3000")
    tri, _ = _port_build("seeded_3000")
    pts = tri.points_std
    for res in (64, 256):
        want = np.asarray(jdt._grid_device(jtri.points_std, jtri.tri_verts, res, jtri.n_tris))
        # JAX's grid of its own triangulation; the port's of the JAX rows.
        got = device_tri._grid_device(
            torch.tensor(np.asarray(jtri.points_std)), torch.tensor(np.asarray(jtri.tri_verts)), res
        )
        np.testing.assert_array_equal(got.numpy(), want)
        host = device_tri._bucket_grid(pts.numpy(), tri.tri_verts.numpy(), res)
        np.testing.assert_array_equal(device_tri._grid_device(pts, tri.tri_verts, res).numpy(), host)
    # from_arrays builds its 2D grid with _grid_device at every size: the
    # build's grid is the host grid of its own rows.
    host = device_tri._bucket_grid(pts.numpy(), tri.tri_verts.numpy(), tri.grid_res)
    np.testing.assert_array_equal(tri.grid_tri.numpy(), host)


def test_slice_past_threshold_matches_jax(jax_builds, monkeypatch):
    # ScatteredInterp past the (lowered) threshold: the seeded chunked build,
    # the cell index past the (lowered) brute-force limit, and eval, against
    # the JAX interpolant of the JAX build.
    jtri, jshuffle = jax_builds("seeded_3000")
    sites = BUILDS["seeded_3000"][0]
    values = np.sin(6 * sites[:, 0]) * np.cos(6 * sites[:, 1])
    monkeypatch.setattr(dd, "triangulate", functools.partial(
        dd.triangulate, chunk_threshold=1000, seed_min=1000))
    monkeypatch.setattr(device_tri, "DENSE_LOCATE_MAX_TRIS", 2000)
    si = ScatteredInterp(sites, values, flags=jht.NOSTANDARDIZE, engine="device",
                         device="cpu")
    q = np.random.default_rng(4).uniform(-0.45, 0.45, (20_000, 2))
    got = si.eval(q).numpy()
    assert si._cells is not None
    jresp = jdt.response_for_build(jshuffle, values)
    want = np.asarray(jdt.interp(jtri, jresp, jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
