"""The port's 3D cell index (models/device_tri: the 3D host rasterizer, the
device build's 3D branch in both layouts, the 3D scoring of locate_cells)
and its 3D walk-start grid against the JAX package's, on the same
triangulation (carried across by models/convert.from_jax_arrays), as
tests/test_device_tri.py::TestCellIndex3d holds the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import device_tri as jdt
from gsl_scattered_interpolation_tpu.models import host_tree as jht

from gsl_scattered_interpolation_torch.models import convert
from gsl_scattered_interpolation_torch.models import device_tri as dt

_TRIS = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores, and eight threads per worker oversubscribe them many times over
    on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tri3(n, seed):
    """The JAX package's host build + freeze of n uniform 3D sites, and the
    port's copy of it."""
    if (n, seed) not in _TRIS:
        sites = np.random.default_rng(seed).uniform(-0.5, 0.5, size=(n, 3))
        jtri = jdt.freeze(jht.build(sites, flags=jht.NOSTANDARDIZE))
        fields = {k: np.asarray(v) for k, v in jtri._asdict().items()}
        _TRIS[n, seed] = jtri, convert.from_jax_arrays(fields, device="cpu")[0]
    return _TRIS[n, seed]


def _index(monkeypatch, layout, build):
    """(JAX, port) indexes of the 500-site triangulation in one layout."""
    jtri, tri = _tri3(500, 5)
    if layout == "two_stage":
        monkeypatch.setenv("GSI_CELLS3D_PACKED_BYTES", "0")
        monkeypatch.setattr(dt, "CELLS3D_PACKED_BYTES", 0)
    if build == "host":
        jc, c = jdt.build_cell_index(jtri, method="host"), dt.build_cell_index(tri, method="host")
    else:
        jc, c = jdt._build_cell_index_device(jtri), dt._build_cell_index_device(tri)
    assert (c.rows is None) == (layout == "packed") == (jc.rows is None)
    return jtri, jc, tri, c


def _cells_equal(jc, c):
    """Every field equal; the float fields bit for bit."""
    assert (c.res, c.k, c.complete) == (jc.res, jc.k, jc.complete)
    np.testing.assert_array_equal(c.overflow.numpy(), np.asarray(jc.overflow))
    np.testing.assert_array_equal(c.hint.numpy(), np.asarray(jc.hint))
    assert c.table.dtype == (torch.float32 if c.rows is None else torch.int32)
    np.testing.assert_array_equal(c.table.numpy(), np.asarray(jc.table))
    if c.rows is not None:
        assert c.rows.dtype == torch.float32
        np.testing.assert_array_equal(c.rows.numpy(), np.asarray(jc.rows))


def _margins(tri, cell, tets, G):
    """Exact (float64) dilated-face margin of cell centre and tetrahedra,
    over the face normal's 1-norm: the device filter keeps a pair iff this
    is >= -32 float32 eps, up to float32 rounding."""
    V = tri.points_std.numpy()[tri.tri_verts.numpy()[tets]]  # [k, 4, 3]
    C = (np.array([cell // (G * G), (cell // G) % G, cell % G]) + 0.5) / G - 0.5
    out = np.full(len(tets), np.inf)
    for kf, (i, j, l) in enumerate(dt._FACES_3D):
        a = V[:, i]
        n = np.cross(V[:, j] - a, V[:, l] - a)
        n *= np.where(np.sum(n * (V[:, kf] - a), 1) < 0, -1.0, 1.0)[:, None]
        mag = np.abs(n).sum(1)
        out = np.minimum(out, (n @ C - np.sum(n * a, 1)) / mag + 0.5 / G)
    return out


def _device_cells_equal(jc, c, tri):
    """The device index against JAX's.  XLA contracts the filter's cross
    products into fused multiply-adds on the CPU, where the port rounds
    each product, so a pair at the filter's boundary can be kept by one
    build and not the other: every such pair must lie within 8 float32
    eps of the boundary.  Every other field is equal, the float fields bit
    for bit."""
    assert (c.res, c.k, c.complete) == (jc.res, jc.k, jc.complete)
    G, K = c.res, c.k
    if c.rows is None:
        ids = c.table.numpy().reshape(-1, 13, K)
        jids = np.asarray(jc.table).reshape(-1, 13, K)
        ids, jids = ids[:, 12].astype(np.int64), jids[:, 12].astype(np.int64)
    else:
        ids, jids = c.table.numpy(), np.asarray(jc.table)
        np.testing.assert_array_equal(c.rows.numpy(), np.asarray(jc.rows))
    differ = np.nonzero((ids != jids).any(1))[0]
    assert len(differ) <= 3
    eps = np.finfo(np.float32).eps
    for cell in differ:
        a, b = set(ids[cell][ids[cell] >= 0]), set(jids[cell][jids[cell] >= 0])
        m = _margins(tri, cell, np.array(sorted(a ^ b)), G)
        assert (np.abs(m + 32 * eps) < 8 * eps).all(), m
    same = np.ones(len(ids), bool)
    same[differ] = False
    np.testing.assert_array_equal(c.overflow.numpy()[same], np.asarray(jc.overflow)[same])
    np.testing.assert_array_equal(c.hint.numpy()[same], np.asarray(jc.hint)[same])
    np.testing.assert_array_equal(c.table.numpy()[same], np.asarray(jc.table)[same])
    return len(differ)


@pytest.mark.parametrize("layout", ["packed", "two_stage"])
@pytest.mark.parametrize("build", ["host", "device"])
def test_index_3d_equals_jax(monkeypatch, build, layout):
    jtri, jc, tri, c = _index(monkeypatch, layout, build)
    if build == "host":
        _cells_equal(jc, c)
    else:
        _device_cells_equal(jc, c, tri)
    assert c.k == 24 and c.res == int(np.clip(round(1.7 * tri.n_tris ** (1 / 3)), 8, 160))
    if build == "host":
        assert c.complete and c.n_bad == 0
    else:
        # The cage slivers pass the span cap: incomplete, and counted.
        assert not c.complete and 0 < c.n_bad < c.n_pairs
    assert c.overflow.any()  # the walk takes part


@pytest.mark.parametrize("layout", ["packed", "two_stage"])
@pytest.mark.parametrize("build", ["host", "device"])
def test_locate_cells_3d_equals_jax(monkeypatch, build, layout):
    jtri, jc, tri, c = _index(monkeypatch, layout, build)
    rng = np.random.default_rng(7)
    Q = np.concatenate([
        rng.uniform(-0.49, 0.49, size=(3000, 3)),
        [[0.7, 0.0, 0.1], [-3.0, 0.2, 0.0], [1e7, 1e7, 1e7], [0.5, 0.5, 0.5]],
    ])
    jl, jw, ji = jdt.locate_cells(jtri, jc, jnp.asarray(Q))
    leaf, w, ok = dt.locate_cells(tri, c, torch.as_tensor(Q))
    np.testing.assert_allclose(w.numpy().min(-1), np.asarray(jw).min(-1), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ji))
    _, wd, _ = dt.locate_dense(tri, torch.as_tensor(Q[:3000]))
    np.testing.assert_allclose(w.numpy()[:3000].min(-1), wd.numpy().min(-1), rtol=0, atol=1e-9)
    resp = np.concatenate([np.zeros(4), rng.standard_normal(500)])
    jv = jdt.interp(jtri, jnp.asarray(resp), jnp.asarray(Q), method="cells", cells=jc)
    v = dt.interp(tri, torch.as_tensor(resp), torch.as_tensor(Q), method="cells", cells=c)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-9)
    assert v[-2] == 0.0


def test_budget_spill_stays_exact():
    # A pair budget too small for the boxes drops pairs: the index reports
    # itself incomplete and every miss walks.
    jtri, tri = _tri3(500, 5)
    c = dt._build_cell_index_device(tri, pair_budget_override=1)
    jc = jdt._build_cell_index_device(jtri, pair_budget_override=1)
    assert not c.complete and c.n_bad > c.n_pairs // 2
    _device_cells_equal(jc, c, tri)
    Q = np.random.default_rng(8).uniform(-0.49, 0.49, size=(2000, 3))
    _, w, ok = dt.locate_cells(tri, c, torch.as_tensor(Q))
    _, wd, _ = dt.locate_dense(tri, torch.as_tensor(Q))
    np.testing.assert_allclose(w.numpy().min(-1), wd.numpy().min(-1), rtol=0, atol=1e-9)
    assert ok.all()


def test_large_query_batches_take_blocks(monkeypatch):
    # More queries than one block of _locate_cells_score_3d, in both
    # layouts: the blocked scoring equals one unblocked pass.
    jtri, tri = _tri3(200, 11)
    Q = torch.as_tensor(np.random.default_rng(12).uniform(-0.45, 0.45, size=(300_000, 3)))
    for layout in ("packed", "two_stage"):
        if layout == "two_stage":
            monkeypatch.setattr(dt, "CELLS3D_PACKED_BYTES", 0)
        c = dt.build_cell_index(tri, method="host")
        cid, leaf, bestw, _ = dt._locate_cells_score_3d(tri, c, Q)
        sub = slice(262_140, 262_150)
        _, leaf1, bestw1, _ = dt._locate_cells_score_3d(tri, c, Q[sub])
        np.testing.assert_array_equal(leaf[sub].numpy(), leaf1.numpy())
        np.testing.assert_array_equal(bestw[sub].numpy(), bestw1.numpy())
        _, wd, _ = dt.locate_dense(tri, Q[:20_000])
        _, w, _ = dt.locate_cells(tri, c, Q[:20_000])
        np.testing.assert_allclose(w.numpy().min(-1), wd.numpy().min(-1), rtol=0, atol=1e-9)


def test_device_grid_3d_equals_jax_and_host():
    # from_arrays builds the 3D walk-start grid on the arrays' device; it
    # equals the JAX package's device grid and the host _bucket_grid.
    import jax

    jtri, tri = _tri3(500, 5)
    for G in (8, 24):
        g = dt._grid_device(tri.points_std, tri.tri_verts, G)
        ref = jdt._bucket_grid(np.asarray(jtri.points_std), np.asarray(jtri.tri_verts), G)
        jg = jax.jit(jdt._grid_device, static_argnums=(2, 3))(
            jtri.points_std, jtri.tri_verts, G, jtri.n_tris
        )
        np.testing.assert_array_equal(g.numpy(), ref)
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    tv = tri.tri_verts
    built = dt.from_arrays(
        tri.points_raw.numpy(), tri.shift.numpy(), tri.scale.numpy(), tv, tri.tri_nbrs,
        torch.ones(tv.shape[0], dtype=torch.bool), device="cpu",
    )
    assert built.grid_res == tri.grid_res == dt._grid_res_3d(tv.shape[0], 256)
    np.testing.assert_array_equal(built.grid_tri.numpy(), np.asarray(jtri.grid_tri))


def test_auto_index_method_3d():
    lim = dt.DEVICE_INDEX_MIN_TETS
    assert dt.auto_index_method("cpu", lim - 1, 3) == "host"
    assert dt.auto_index_method("cpu", lim, 3) == "device"
    assert dt.auto_index_method("cuda", 10, 3) == "device"
    assert dt.auto_index_method("cpu", lim, 2) == "host"  # 2D: its own threshold
