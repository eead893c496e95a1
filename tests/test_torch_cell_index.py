"""Port's cell index (models/device_tri: build_cell_index, the device build,
locate_cells, interp(method="cells")) vs the JAX package's, on the same
triangulation (carried across by models/convert.from_jax_arrays)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import device_tri as jdt
from gsl_scattered_interpolation_tpu.models import host_tree as jht

from gsl_scattered_interpolation_torch.models import convert
from gsl_scattered_interpolation_torch.models import device_tri as dt
from gsl_scattered_interpolation_torch.utils import errors


def _port(jtri):
    fields = {k: np.asarray(v) for k, v in jtri._asdict().items()}
    return convert.from_jax_arrays(fields, device="cpu")[0]


_TRIS = {}


def _tri(n, seed):
    """The JAX package's host build + freeze of n uniform sites, and the
    port's copy of it (tests/test_device_tri.py::TestCellIndex._tri)."""
    if (n, seed) not in _TRIS:
        sites = np.random.default_rng(seed).uniform(-0.5, 0.5, size=(n, 2))
        jtri = jdt.freeze(jht.build(sites, flags=jht.NOSTANDARDIZE), grid_res=64)
        _TRIS[n, seed] = jtri, _port(jtri)
    return _TRIS[n, seed]


def _resp(n, rng):
    return np.concatenate([np.zeros(3), rng.standard_normal(n)])


def _cells_equal(jc, c, float_ulps=0):
    """Integer fields equal; float fields within ``float_ulps`` f32 ulps."""
    assert (c.res, c.k, c.complete) == (jc.res, jc.k, jc.complete)
    assert c.rows is None and c.table.dtype == torch.float32
    np.testing.assert_array_equal(c.overflow.numpy(), np.asarray(jc.overflow))
    np.testing.assert_array_equal(c.hint.numpy(), np.asarray(jc.hint))
    ours = c.table.numpy().reshape(-1, 7, c.k)
    ref = np.asarray(jc.table).reshape(-1, 7, jc.k)
    np.testing.assert_array_equal(ours[:, 6], ref[:, 6])
    ulps = np.abs(ours.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
    assert ulps.max() <= float_ulps


def _min_w_and_in(jtri, jc, tri, c, Q, jax_kw=None, **kw):
    """locate_cells of both packages: (ours, ref) min weights, in_domain.
    ``jax_kw`` go to the JAX package's call only."""
    jl, jw, ji = jdt.locate_cells(jtri, jc, jnp.asarray(Q), **kw, **(jax_kw or {}))
    leaf, w, ok = dt.locate_cells(tri, c, torch.as_tensor(Q), **kw)
    assert leaf.dtype == torch.int64
    return (w.numpy().min(-1), ok.numpy()), (np.asarray(jw).min(-1), np.asarray(ji))


@pytest.mark.parametrize("n,seed,K", [(800, 0, 16), (300, 3, 2)])
def test_host_index_equals_jax(n, seed, K):
    jtri, tri = _tri(n, seed)
    jc, c = jdt.build_cell_index(jtri, K=K, method="host"), dt.build_cell_index(tri, K=K, method="host")
    _cells_equal(jc, c)
    np.testing.assert_array_equal(c.table.numpy(), np.asarray(jc.table))
    assert c.complete and (K > 2 or c.overflow.sum() > 100)


def test_qcentered_tables_equal_jax():
    jtri, tri = _tri(800, 0)
    for ours, ref in zip(dt._qcentered_host(tri), jdt._qcentered_host(jtri)):
        np.testing.assert_array_equal(ours, ref)
    for ours, ref in zip(dt._qcentered_tables(tri), jdt._qcentered_tables(jtri)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-12, atol=0)
    rng = np.random.default_rng(2)
    sites3 = rng.uniform(-0.5, 0.5, size=(30, 3))
    jtri3 = jdt.freeze(jht.build(sites3, flags=jht.NOSTANDARDIZE))
    for ours, ref in zip(dt._qcentered_host(_port(jtri3)), jdt._qcentered_host(jtri3)):
        np.testing.assert_array_equal(ours, ref)


# The port ranks by one sort only; it is held against both of the JAX
# package's rankings.
@pytest.mark.parametrize("rank", ["sort", "minround"])
def test_device_index_equals_jax(rank):
    # TestCellIndexDevice::test_2d_matches_dense: the cage slivers pass the
    # span cap, so the device index is incomplete and stays exact.
    jtri, tri = _tri(800, 0)
    jc = jdt._build_cell_index_device(jtri, rank=rank)
    c = dt._build_cell_index_device(tri)
    assert not c.complete
    _cells_equal(jc, c)
    Q = np.random.default_rng(1).uniform(-0.49, 0.49, size=(3000, 2))
    (mw, ok), (jmw, jok) = _min_w_and_in(jtri, jc, tri, c, Q)
    np.testing.assert_allclose(mw, jmw, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ok, jok)
    _, wd, _ = dt.locate_dense(tri, torch.as_tensor(Q))
    np.testing.assert_allclose(mw, wd.numpy().min(-1), rtol=0, atol=1e-9)
    # Out-of-square and cage-region queries (the walk's route).
    Q2 = np.array([[5.0, 5.0], [-3.0, 0.2], [0.0, 0.0]])
    resp = torch.as_tensor(_resp(800, np.random.default_rng(5)))
    jv = np.asarray(jdt.interp(jtri, jnp.asarray(resp.numpy()), jnp.asarray(Q2), method="cells", cells=jc))
    v = dt.interp(tri, resp, torch.as_tensor(Q2), method="cells", cells=c).numpy()
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-9)
    np.testing.assert_allclose(
        v, dt.interp(tri, resp, torch.as_tensor(Q2), method="walk").numpy(), rtol=0, atol=1e-9
    )


def test_device_lists_match_host_for_import():
    # TestCellIndexDevice::test_2d_lists_match_host_for_import: a Qhull
    # import has no cage slivers, so the device index is complete and each
    # of its lists holds only triangles of the host rasterizer's list.
    from scipy.spatial import Delaunay

    from gsl_scattered_interpolation_tpu.models import geometry_extras as gx

    rng = np.random.default_rng(3)
    sites = rng.uniform(-0.5, 0.5, size=(1200, 2))
    jtri = gx.from_scipy_delaunay(Delaunay(sites), sites)
    tri = _port(jtri)
    hostc = dt.build_cell_index(tri, method="host")
    c = dt._build_cell_index_device(tri, grid_res=hostc.res, K=hostc.k)
    assert c.complete
    _cells_equal(jdt._build_cell_index_device(jtri, grid_res=hostc.res, K=hostc.k), c)
    ids_h = hostc.table.numpy().reshape(-1, 7, hostc.k)[:, 6]
    ids_d = c.table.numpy().reshape(-1, 7, c.k)[:, 6]
    ok_rows = ~hostc.overflow.numpy()
    subset = ((ids_d[ok_rows, :, None] == ids_h[ok_rows, None, :]).any(-1) | (ids_d[ok_rows] < 0)).all(-1)
    assert subset.all(), (~subset).sum()
    Q = torch.as_tensor(rng.uniform(-0.45, 0.45, size=(4000, 2)))
    _, wh, _ = dt.locate_cells(tri, hostc, Q)
    _, wd, _ = dt.locate_cells(tri, c, Q)
    np.testing.assert_allclose(wh.numpy().min(-1), wd.numpy().min(-1), rtol=0, atol=1e-9)


def test_budget_spill_reports_incomplete_and_stays_exact():
    # TestCellIndexDevice::test_budget_spill_stays_exact
    jtri, tri = _tri(600, 11)
    jc = jdt._build_cell_index_device(jtri, pair_budget_override=1)
    c = dt._build_cell_index_device(tri, pair_budget_override=1)
    assert not c.complete
    _cells_equal(jc, c)
    Q = np.random.default_rng(12).uniform(-0.49, 0.49, size=(2000, 2))
    (mw, ok), (jmw, jok) = _min_w_and_in(jtri, jc, tri, c, Q)
    np.testing.assert_allclose(mw, jmw, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ok, jok)
    _, wd, _ = dt.locate_dense(tri, torch.as_tensor(Q))
    np.testing.assert_allclose(mw, wd.numpy().min(-1), rtol=0, atol=1e-9)


def test_locate_cells_matches_jax_and_dense():
    # TestCellIndex::test_matches_dense_locate
    jtri, tri = _tri(800, 0)
    jc, c = jdt.build_cell_index(jtri), dt.build_cell_index(tri)
    rng = np.random.default_rng(1)
    Q = rng.uniform(-0.49, 0.49, size=(3000, 2))
    (mw, ok), (jmw, jok) = _min_w_and_in(jtri, jc, tri, c, Q)
    np.testing.assert_allclose(mw, jmw, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ok, jok)
    _, wd, _ = dt.locate_dense(tri, torch.as_tensor(Q))
    np.testing.assert_allclose(mw, wd.numpy().min(-1), rtol=0, atol=1e-9)
    resp = _resp(800, rng)
    jv = np.asarray(jdt.interp(jtri, jnp.asarray(resp), jnp.asarray(Q), method="cells", cells=jc))
    for method in ("cells", "auto"):
        v = dt.interp(tri, torch.as_tensor(resp), torch.as_tensor(Q), method=method, cells=c)
        np.testing.assert_allclose(v.numpy(), jv, rtol=0, atol=1e-9)
    vd = dt.interp(tri, torch.as_tensor(resp), torch.as_tensor(Q), method="dense")
    np.testing.assert_allclose(vd.numpy(), jv, rtol=0, atol=1e-9)


def _jax_cells(jtri, jc, Q, monkeypatch):
    """(leaf, w, in_domain, bad) of the JAX package's cell scoring: its
    ``fallback="none"`` outputs, and the queries its walk is handed.  Under
    ``jax.disable_jit`` its ``lax.cond`` runs the taken branch eagerly, and a
    stand-in walk marks the leaves it would set with -7; the walk's buffer
    pads with query 0, so query 0 must be one that walks."""
    import jax

    jl, jw, ji = (np.asarray(a) for a in jdt.locate_cells(jtri, jc, jnp.asarray(Q), fallback="none"))

    def marker(tri, q, start=None, max_steps=128, tol=None):
        n = q.shape[0]
        return jnp.full(n, -7, jnp.int32), jnp.zeros((n, 3)), jnp.zeros(n, bool)

    monkeypatch.setattr(jdt, "locate", marker)
    with jax.disable_jit():
        marked = np.asarray(jdt.locate_cells(jtri, jc, jnp.asarray(Q))[0])
    assert marked[0] == -7
    return jl, jw, ji, marked == -7


@pytest.mark.parametrize("index", ["complete", "overflow", "budget"])
def test_locate_cells_score_2d_matches_jax(monkeypatch, index):
    # The plain 2D scoring (the cell kernel's yardstick on the card) against
    # the JAX package's, on test_locate_cells_matches_jax_and_dense's
    # inputs, with query 0 outside the cage: K = 16 (complete), K = 2
    # (most cells overflow) and a budget-spilled, incomplete device index.
    if index == "budget":
        jtri, tri = _tri(600, 11)
        jc = jdt._build_cell_index_device(jtri, pair_budget_override=1)
        c = dt._build_cell_index_device(tri, pair_budget_override=1)
        assert not c.complete
    else:
        K = 16 if index == "complete" else 2
        jtri, tri = _tri(800, 0)
        jc, c = jdt.build_cell_index(jtri, K=K), dt.build_cell_index(tri, K=K)
        assert c.complete and c.overflow.float().mean() > (0.5 if K == 2 else 0)
    Q = np.random.default_rng(1).uniform(-0.49, 0.49, size=(3000, 2))
    Q = np.concatenate([[[1e7, 1e7]], Q])
    jl, jw, ji, jbad = _jax_cells(jtri, jc, Q, monkeypatch)
    leaf, w, ok, bad = dt._locate_cells_score_2d(tri, c, torch.as_tensor(Q))
    assert leaf.dtype == torch.int64 and ok.dtype == bad.dtype == torch.bool
    np.testing.assert_array_equal(leaf.numpy(), jl)
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ok.numpy(), ji)
    np.testing.assert_array_equal(bad.numpy(), jbad)
    assert 1 < bad.sum() < len(Q)


def test_float32_cpu_scoring_takes_the_plain_version():
    # The kernel serves float32 on the card only: on the CPU, float32
    # queries take the plain version and the wrapper refuses CPU tensors.
    from gsl_scattered_interpolation_torch.ops import cells as cells_ops

    _, tri64 = _tri(800, 0)
    tri = tri64.cast(torch.float32)
    c = dt.build_cell_index(tri)
    Q = torch.as_tensor(np.random.default_rng(2).uniform(-0.49, 0.49, size=(500, 2)), dtype=torch.float32)
    before = cells_ops.cells2d_cuda.launches
    leaf, w, ok = dt.locate_cells(tri, c, Q, fallback="none")
    assert cells_ops.cells2d_cuda.launches == before
    pleaf, pw, pok, _ = dt._locate_cells_score_2d(tri, c, Q)
    torch.testing.assert_close((leaf, w, ok), (pleaf, pw, pok), rtol=0, atol=0)
    assert w.dtype == torch.float32 and float(ok.float().mean()) > 0.99
    with pytest.raises(errors.InvalidArgumentError):
        cells_ops.cells2d_cuda(Q, tri.shift, tri.scale, c.table, c.overflow, tri.affine,
                               c.res, c.k, c.complete)


def test_out_of_square_and_cage():
    # TestCellIndex::test_out_of_square_and_cage
    jtri, tri = _tri(200, 2)
    jc, c = jdt.build_cell_index(jtri), dt.build_cell_index(tri)
    Q = np.array([[5.0, 5.0], [-3.0, 0.2], [0.0, 0.0], [1e7, 1e7]])
    resp = np.concatenate([np.zeros(3), np.ones(200)])
    jv = np.asarray(jdt.interp(jtri, jnp.asarray(resp), jnp.asarray(Q), method="cells", cells=jc))
    v = dt.interp(tri, torch.as_tensor(resp), torch.as_tensor(Q), method="cells", cells=c).numpy()
    np.testing.assert_allclose(v, jv, rtol=0, atol=1e-9)
    vw = dt.interp(tri, torch.as_tensor(resp), torch.as_tensor(Q), method="walk").numpy()
    np.testing.assert_allclose(v, vw, rtol=0, atol=1e-9)
    assert v[-1] == 0.0


def test_small_fallback_frac_still_exact():
    # TestCellIndex::test_small_fallback_cap_still_exact: K=2 overflows
    # most cells, so many queries walk.
    jtri, tri = _tri(300, 3)
    jc, c = jdt.build_cell_index(jtri, K=2), dt.build_cell_index(tri, K=2)
    Q = np.random.default_rng(4).uniform(-0.49, 0.49, size=(512, 2))
    walked = dt.locate.queries
    (mw, ok), (jmw, jok) = _min_w_and_in(jtri, jc, tri, c, Q, jax_kw={"fallback_frac": 512})
    assert dt.locate.queries - walked > 50
    np.testing.assert_allclose(mw, jmw, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ok, jok)
    _, wd, _ = dt.locate_dense(tri, torch.as_tensor(Q))
    np.testing.assert_allclose(mw, wd.numpy().min(-1), rtol=0, atol=1e-9)


def test_fallback_none_matches_jax():
    jtri, tri = _tri(300, 3)
    jc, c = jdt.build_cell_index(jtri, K=2), dt.build_cell_index(tri, K=2)
    Q = np.random.default_rng(6).uniform(-0.49, 0.49, size=(512, 2))
    jl, jw, ji = (np.asarray(a) for a in jdt.locate_cells(jtri, jc, jnp.asarray(Q), fallback="none"))
    walked = dt.locate.queries
    leaf, w, ok = dt.locate_cells(tri, c, torch.as_tensor(Q), fallback="none")
    assert dt.locate.queries == walked
    np.testing.assert_array_equal(leaf.numpy(), jl)
    np.testing.assert_array_equal(ok.numpy(), ji)
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-12)
    assert not ok.all()


def test_grid_eval_reproduces_constant():
    # TestCellIndex::test_jit_and_grid_eval, without the jit.
    jtri, tri = _tri(500, 5)
    c = dt.build_cell_index(tri)
    g = np.linspace(-0.45, 0.45, 40)
    Q = torch.as_tensor(np.stack(np.meshgrid(g, g), -1).reshape(-1, 2))
    out = dt.interp(tri, torch.as_tensor(np.concatenate([np.zeros(3), np.ones(500)])), Q,
                    method="cells", cells=c).numpy()
    interior = (Q.abs() < 0.35).all(dim=1).numpy()
    np.testing.assert_allclose(out[interior], 1.0, rtol=0, atol=1e-9)


def test_auto_method_threshold(monkeypatch):
    # On CUDA always the device build; on the CPU the host's below the
    # threshold.
    for n_tris in (10, dt.DEVICE_INDEX_MIN_TRIS):
        assert dt.auto_index_method("cuda", n_tris) == "device"
    assert dt.auto_index_method("cpu", dt.DEVICE_INDEX_MIN_TRIS - 1) == "host"
    assert dt.auto_index_method("cpu", dt.DEVICE_INDEX_MIN_TRIS) == "device"
    _, tri = _tri(300, 9)
    assert dt.build_cell_index(tri).complete  # host below the threshold
    monkeypatch.setattr(dt, "DEVICE_INDEX_MIN_TRIS", 10)
    assert not dt.build_cell_index(tri).complete  # device: cage slivers dropped


def test_arguments_checked():
    _, tri = _tri(300, 9)
    Q = torch.zeros(1, 2, dtype=torch.float64)
    with pytest.raises(errors.InvalidArgumentError, match="CellIndex"):
        dt.interp(tri, torch.zeros(303, dtype=torch.float64), Q, method="cells")
    with pytest.raises(errors.InvalidArgumentError, match="unknown method"):
        dt.interp(tri, torch.zeros(303, dtype=torch.float64), Q, method="nope")
    with pytest.raises(errors.InvalidArgumentError, match="unknown index method"):
        dt.build_cell_index(tri, method="nope")
    # The index is 2D and 3D (tests/test_torch_cell_index_3d.py); 4D raises.
    sites4 = np.random.default_rng(2).uniform(-0.5, 0.5, size=(12, 4))
    tri4 = _port(jdt.freeze(jht.build(sites4, flags=jht.NOSTANDARDIZE)))
    for method in ("host", "device"):
        with pytest.raises(NotImplementedError, match="2D/3D"):
            dt.build_cell_index(tri4, method=method)


@pytest.mark.parametrize("rank", ["sort", "minround"])
def test_device_index_float32_triangulation(rank):
    # The card's fast path: every integer field and the g fields equal the
    # JAX package's.  A bias is w0 + sum(A * (shift - anchor)) in float32,
    # whose terms cancel; XLA fuses a multiply-add that PyTorch rounds
    # twice.  So each bias is held within two roundings (2 eps) of its
    # terms' magnitude |w0| + sum|A * (shift - anchor)|, not to its own ulp.
    jtri, tri = _tri(800, 0)
    jtri, tri = jtri.cast(jnp.float32), tri.cast(torch.float32)
    jc = jdt._build_cell_index_device(jtri, rank=rank)
    c = dt._build_cell_index_device(tri)
    assert c.complete == jc.complete
    np.testing.assert_array_equal(c.overflow.numpy(), np.asarray(jc.overflow))
    np.testing.assert_array_equal(c.hint.numpy(), np.asarray(jc.hint))
    ours = c.table.numpy().reshape(-1, 7, c.k)
    ref = np.asarray(jc.table).reshape(-1, 7, jc.k)
    np.testing.assert_array_equal(ours[:, [0, 1, 2, 3, 6]], ref[:, [0, 1, 2, 3, 6]])
    A = tri.affine[:, :4].reshape(-1, 2, 2).double()
    anchor, w0 = tri.affine[:, 4:6].double(), tri.affine[:, 6:].double()
    terms = (A * (tri.shift.double() - anchor)[:, None, :]).abs().sum(-1)
    mag = (w0.abs() + terms).numpy()[np.maximum(ours[:, 6].astype(np.int64), 0)]  # [G^2, K, 2]
    diff = np.abs(ours[:, 4:6].astype(np.float64) - ref[:, 4:6]).transpose(0, 2, 1)
    listed = ours[:, 6] >= 0
    assert (diff[listed] <= 2 * np.finfo(np.float32).eps * mag[listed]).all()
    np.testing.assert_array_equal(ours[:, 4:6][~listed[:, None, :].repeat(2, 1)],
                                  ref[:, 4:6][~listed[:, None, :].repeat(2, 1)])
