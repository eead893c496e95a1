"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a CUDA card (it has no JAX, so skip the JAX
conftest):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips.  Whether a card is present is decided
inside each test, never while the module is imported.
"""

import numpy as np
import pytest
import torch
from walk2d_emulation import bary_values, fixture_tri, walk2d_plain

from gsl_scattered_interpolation_torch import ScatteredInterp
from gsl_scattered_interpolation_torch.models import device_tri, host_tree
from gsl_scattered_interpolation_torch.ops import cells as cells_ops
from gsl_scattered_interpolation_torch.ops import locate
from gsl_scattered_interpolation_torch.ops import walk as walk_ops
from gsl_scattered_interpolation_torch.utils import datasets, errors

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tri(n_sites, seed, device):
    sites = np.random.default_rng(seed).uniform(-0.5, 0.5, size=(n_sites, 2))
    tree = host_tree.build(sites, flags=host_tree.NOSTANDARDIZE)
    return device_tri.freeze(tree, device=device).cast(torch.float32)


# Ragged sizes: B not a multiple of the 1,024-query tile, T below, at and
# past the 512-triangle shared-memory chunk.
@pytest.mark.parametrize("n_sites,n_q", [(1, 1), (300, 1000), (511, 257), (1500, 70_001)])
def test_kernel_equals_plain(cuda, n_sites, n_q):
    tri = _tri(n_sites, n_sites, cuda)
    gen = torch.Generator(device=cuda).manual_seed(n_q)
    q = torch.rand(n_q, 2, generator=gen, device=cuda) * 1.2 - 0.6
    centre, g_pack, b_pack = locate.pack_tables(tri)
    qc = (q - centre).contiguous()
    before = locate.locate2d_cuda.launches
    got = locate.locate2d_cuda(q, g_pack, b_pack, centre)
    torch.cuda.synchronize()
    assert locate.locate2d_cuda.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n_q,)
    torch.testing.assert_close(got, locate.locate2d_ref(qc, g_pack, b_pack), rtol=0, atol=0)


def test_tie_goes_to_lowest_index(cuda):
    # Column 1 and column 1025 (across a chunk) tie for every query.
    T = 1100
    g = torch.zeros(4, T, device=cuda)
    b = torch.full((2, T), -5.0, device=cuda)
    b[:, 0] = -1e30
    for t in (1, 1025):
        g[0, t] = g[3, t] = 1.0
        b[:, t] = 0.2
    q = torch.tensor([[0.1, 0.1], [-0.05, 0.02], [3.0, -2.0]], device=cuda)
    got = locate.locate2d_cuda(q, g, b, torch.zeros(2, device=cuda))
    assert got.tolist() == [1, 1, 1]
    assert locate.locate2d_ref(q, g, b).tolist() == [1, 1, 1]


def test_wrapper_checks_inputs(cuda):
    g = torch.zeros(4, 3, device=cuda)
    b = torch.zeros(2, 3, device=cuda)
    q = torch.zeros(5, 2, device=cuda)
    c = torch.zeros(2, device=cuda)
    with pytest.raises(errors.InvalidArgumentError):
        locate.locate2d_cuda(q.double(), g, b, c)
    with pytest.raises(errors.InvalidArgumentError):
        locate.locate2d_cuda(torch.zeros(2, 5, device=cuda).T, g, b, c)
    with pytest.raises(errors.InvalidArgumentError):
        locate.locate2d_cuda(q, g[:3], b, c)
    with pytest.raises(errors.InvalidArgumentError):
        locate.locate2d_cuda(q, g, b, c[:1])
    assert locate.locate2d_cuda(q[:0], g, b, c).shape == (0,)


def _force_split(monkeypatch, slices):
    """Make locate2d_cuda split into about ``slices`` slices (None: the
    card's plan)."""
    if slices is None:
        return

    def forced(n_q, n_t, n_sms):
        length = -(-n_t // slices)
        length = -(-length // locate.GROUP) * locate.GROUP
        return -(-n_t // length), length

    monkeypatch.setattr(locate, "plan", forced)


def _check_leaves_and_weights(tri, q):
    """The weights route and the leaf route against their plain versions,
    to the bit."""
    centre, g_pack, b_pack = locate.pack_tables(tri)
    ref = locate.locate2d_ref((q - centre).contiguous(), g_pack, b_pack)
    before = locate.locate2d_cuda.launches
    leaf, w = locate.locate_weights_kernel(tri, q)
    only = locate.locate_dense_kernel(tri, q)
    torch.cuda.synchronize()
    assert locate.locate2d_cuda.launches == before + 2
    assert leaf.dtype == torch.int32 and w.dtype == torch.float32 and w.shape == (q.shape[0], 3)
    torch.testing.assert_close(leaf, ref, rtol=0, atol=0)
    torch.testing.assert_close(only, ref, rtol=0, atol=0)
    torch.testing.assert_close(w, device_tri._weights(tri, ref, q), rtol=0, atol=0)


# Split and unsplit grids; B not a multiple of the 8-query register block
# or the 1,024-query tile; T not a multiple of the 32-triangle group or the
# 512-triangle chunk; queries inside, just outside and far outside the hull.
@pytest.mark.parametrize("slices", [None, 1, 3, 16])
@pytest.mark.parametrize("n_sites,n_q", [(1, 1), (300, 1000), (511, 257), (1500, 70_001),
                                         (2000, 1021)])
def test_weights_kernel_equals_plain(cuda, monkeypatch, n_sites, n_q, slices):
    _force_split(monkeypatch, slices)
    tri = _tri(n_sites, n_sites, cuda)
    gen = torch.Generator(device=cuda).manual_seed(n_q)
    q = torch.rand(n_q, 2, generator=gen, device=cuda) * 1.2 - 0.6
    q[::7] *= 40.0  # far outside the hull
    before = locate.locate2d_cuda.kernel_launches
    _check_leaves_and_weights(tri, q)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    split, _ = locate.plan(n_q, tri.n_tris, n_sms)
    assert locate.locate2d_cuda.kernel_launches == before + 2 * locate.kernels_per_call(split)


def test_single_triangle(cuda):
    g = torch.tensor([[1.0], [0.0], [0.0], [1.0]], device=cuda)
    b = torch.tensor([[0.2], [0.3]], device=cuda)
    q = torch.rand(1000, 2, device=cuda) * 10 - 5
    got = locate.locate2d_cuda(q, g, b, torch.zeros(2, device=cuda))
    assert got.tolist() == [0] * 1000
    torch.testing.assert_close(got, locate.locate2d_ref(q, g, b), rtol=0, atol=0)


@pytest.mark.parametrize("slices", [1, 2, 3, 7])
def test_duplicated_triangles_keep_the_earlier_index(cuda, monkeypatch, slices):
    # The table twice over: every triangle's twin lies in a later slice
    # (or later in the same one), and the earlier index must win.
    _force_split(monkeypatch, slices)
    tri = _tri(700, 3, cuda)
    centre, g_pack, b_pack = locate.pack_tables(tri)
    T0 = tri.n_tris
    g2, b2 = torch.cat([g_pack, g_pack], 1).contiguous(), torch.cat([b_pack, b_pack], 1).contiguous()
    q = torch.rand(20_000, 2, device=cuda) * 1.1 - 0.55
    qc = (q - centre).contiguous()
    ref = locate.locate2d_ref(qc, g2, b2)
    assert int(ref.max()) < T0
    torch.testing.assert_close(locate.locate2d_cuda(q, g2, b2, centre), ref, rtol=0, atol=0)


@pytest.mark.parametrize("slices", [None, 1, 5])
def test_degenerate_rows_never_win(cuda, monkeypatch, slices):
    _force_split(monkeypatch, slices)
    tri = _tri(900, 4, cuda)
    centre, g_pack, b_pack = locate.pack_tables(tri)
    b_pack = b_pack.clone()
    b_pack[:, ::3] = -1e30  # a third of the triangles degenerate
    q = torch.rand(30_000, 2, device=cuda) * 1.4 - 0.7
    qc = (q - centre).contiguous()
    ref = locate.locate2d_ref(qc, g_pack, b_pack)
    assert not bool((ref % 3 == 0).any())
    torch.testing.assert_close(locate.locate2d_cuda(q, g_pack, b_pack, centre), ref,
                               rtol=0, atol=0)
    # Every triangle degenerate: the first one, as argmax gives it.
    b_all = torch.full_like(b_pack, -1e30)
    torch.testing.assert_close(locate.locate2d_cuda(q, g_pack, b_all, centre),
                               locate.locate2d_ref(qc, g_pack, b_all), rtol=0, atol=0)


def test_wrapper_checks_weights_inputs(cuda):
    g = torch.zeros(4, 3, device=cuda)
    b = torch.zeros(2, 3, device=cuda)
    q = torch.zeros(5, 2, device=cuda)
    c = torch.zeros(2, device=cuda)
    a = torch.zeros(3, 8, device=cuda)
    with pytest.raises(errors.InvalidArgumentError):
        locate.locate2d_cuda(q, g, b, c.double(), affine=a)
    with pytest.raises(errors.InvalidArgumentError):
        locate.locate2d_cuda(q, g, b, centre=c, affine=a[:2])
    with pytest.raises(errors.InvalidArgumentError):
        locate.locate2d_cuda(q, g, b, centre=c, affine=a.double())
    with pytest.raises(errors.InvalidArgumentError):
        locate.locate2d_cuda(q, g, b, centre=c[:1], affine=a)
    leaf, w = locate.locate2d_cuda(q[:0], g, b, centre=c, affine=a)
    assert leaf.shape == (0,) and w.shape == (0, 3)


def test_facade_on_card_matches_cpu(cuda):
    sites, temps = datasets.weather()
    rng = np.random.default_rng(0)
    Q = rng.uniform([-89.0, 41.2], [-87.0, 42.8], size=(3000, 2))
    gpu = ScatteredInterp(sites, temps, key=0, engine="host")
    cpu = ScatteredInterp(sites, temps, key=0, engine="host", device="cpu")
    assert gpu.tri.device.type == "cuda" and gpu.tri.dtype == torch.float32
    before = locate.locate2d_cuda.launches
    v = gpu.eval(Q)
    assert locate.locate2d_cuda.launches == before + 1
    np.testing.assert_allclose(v.cpu().numpy(), cpu.eval(Q).numpy(), rtol=0, atol=1e-5 * 300)
    vals, status = gpu.eval_e(np.array([[-88.0, 41.5], [1e7, 1e7]]))
    assert status.tolist() == [errors.SUCCESS, errors.EDOM] and vals[1] == 0
    # Gradients jump across edges, so compare them at triangle centroids.
    tv = cpu.tri.tri_verts.long()
    data = (tv > 2).all(dim=1)
    C = cpu.tri.points_raw[tv[data]].mean(dim=1).numpy()
    np.testing.assert_allclose(
        gpu.eval_deriv(C).cpu().numpy(), cpu.eval_deriv(C).numpy(), rtol=1e-4, atol=1e-3
    )


def _mid_build(n, dtype, device):
    """The port's build after 4 rounds of split + 2 flip sub-rounds."""
    from gsl_scattered_interpolation_torch.models import device_delaunay as dd

    sites = np.random.default_rng(3).uniform(-0.5, 0.5, size=(n, 2))
    *_, cage_std, sites_std = dd.build_inputs(sites, flags=host_tree.NOSTANDARDIZE, dtype=dtype)
    pts = torch.cat([cage_std, torch.as_tensor(sites_std, dtype=dtype)]).to(device)
    st = dd._init_state(pts, n)
    for _ in range(4):
        st = dd._split_round(pts, st)
        st, _ = dd._flip_rounds(pts, st, 2)
    return pts, st


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_candmath_kernel_equals_plain(cuda, dtype):
    from gsl_scattered_interpolation_torch.models import device_delaunay as dd
    from gsl_scattered_interpolation_torch.ops import candmath

    pts, st = _mid_build(5000, dtype, cuda)
    M = st.tri_v.shape[0] - 1
    rows = torch.arange(M, dtype=torch.int32, device=cuda)
    _, _, args = dd._edge_candidate_inputs(
        pts, st.tri_v, st.tri_n, st.cc, rows, torch.ones(M, dtype=torch.bool, device=cuda)
    )
    ref = candmath.edge_candidates_math_ref(*args)
    before = candmath.edge_candidates_math_cuda.launches
    got = candmath.edge_candidates_math(*args)
    torch.cuda.synchronize()
    assert candmath.edge_candidates_math_cuda.launches == before + 1
    assert got.dtype == torch.bool and got.shape == (M, 3)
    assert int(ref.sum()) > 0
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_device_build_on_card_equals_cpu(cuda):
    from gsl_scattered_interpolation_torch.models import device_delaunay as dd
    from gsl_scattered_interpolation_torch.ops import candmath

    sites = np.random.default_rng(1000).uniform(-0.5, 0.5, size=(1000, 2))
    for dtype in (torch.float32, torch.float64):
        before = candmath.edge_candidates_math_cuda.launches
        gpu, sh_gpu = dd.triangulate(sites, flags=host_tree.NOSTANDARDIZE, dtype=dtype)
        assert candmath.edge_candidates_math_cuda.launches > before
        cpu, sh_cpu = dd.triangulate(
            sites, flags=host_tree.NOSTANDARDIZE, dtype=dtype, device="cpu"
        )
        assert gpu.tri_verts.device.type == "cuda"
        np.testing.assert_array_equal(sh_gpu, sh_cpu)
        torch.testing.assert_close(gpu.tri_verts.cpu(), cpu.tri_verts, rtol=0, atol=0)
        torch.testing.assert_close(gpu.tri_nbrs.cpu(), cpu.tri_nbrs, rtol=0, atol=0)


def test_device_engine_on_card_matches_cpu(cuda):
    from gsl_scattered_interpolation_torch.ops import candmath

    sites, temps = datasets.weather()
    rng = np.random.default_rng(0)
    Q = rng.uniform([-89.0, 41.2], [-87.0, 42.8], size=(3000, 2))
    b_loc, b_cand = locate.locate2d_cuda.launches, candmath.edge_candidates_math_cuda.launches
    gpu = ScatteredInterp(sites, temps, key=0, engine="device")
    cpu = ScatteredInterp(sites, temps, key=0, engine="device", device="cpu", dtype=torch.float32)
    assert gpu.tri.dtype == torch.float32
    v = gpu.eval(Q)
    assert locate.locate2d_cuda.launches > b_loc
    assert candmath.edge_candidates_math_cuda.launches > b_cand
    np.testing.assert_array_equal(gpu.tri.tri_verts.cpu().numpy(), cpu.tri.tri_verts.numpy())
    np.testing.assert_allclose(v.cpu().numpy(), cpu.eval(Q).numpy(), rtol=0, atol=1e-5 * 300)


def _at_scale_facades(n_sites, device_gpu):
    """The device engine's float32 facades of n_sites uniform sites on the
    card and on the CPU."""
    sites = np.random.default_rng(5).uniform(-0.5, 0.5, size=(n_sites, 2))
    vals = np.sin(6 * sites[:, 0]) * np.cos(6 * sites[:, 1])
    kw = dict(flags=host_tree.NOSTANDARDIZE, engine="device", dtype=torch.float32)
    return ScatteredInterp(sites, vals, **kw), ScatteredInterp(sites, vals, device="cpu", **kw)


def test_cell_path_on_card_equals_cpu(cuda):
    # 20,000 sites: T = 40,001, past the brute-force limit, so eval builds
    # the cell index on the card (the device build, as for any CUDA
    # triangulation) and answers through locate_cells and the walk.  The
    # CPU facade is given the same build.
    gpu, cpu = _at_scale_facades(20_000, cuda)
    torch.testing.assert_close(gpu.tri.tri_verts.cpu(), cpu.tri.tri_verts, rtol=0, atol=0)
    Q = np.random.default_rng(6).uniform(-0.5, 0.5, size=(200_000, 2))
    before = locate.locate2d_cuda.launches
    before_cells = cells_ops.cells2d_cuda.launches
    v = gpu.eval(Q)
    assert locate.locate2d_cuda.launches == before  # the cells route
    assert cells_ops.cells2d_cuda.launches == before_cells + 1  # its kernel
    gc = gpu._cells
    cc = cpu._cells = device_tri.build_cell_index(cpu.tri, method="device")
    assert gc.table.device.type == "cuda" and gc.complete == cc.complete
    for name in ("overflow", "hint"):
        torch.testing.assert_close(getattr(gc, name).cpu(), getattr(cc, name), rtol=0, atol=0)
    got, want = gc.table.cpu().reshape(-1, 7, gc.k), cc.table.reshape(-1, 7, cc.k)
    torch.testing.assert_close(got[:, 6], want[:, 6], rtol=0, atol=0)
    assert int((got.view(torch.int32).long() - want.view(torch.int32).long()).abs().max()) <= 1
    np.testing.assert_allclose(v.cpu().numpy(), cpu.eval(Q).numpy(), rtol=0, atol=1e-6)
    leaf, _, ok = device_tri.locate_cells(gpu.tri, gc, gpu._queries(Q))
    cleaf, _, cok = device_tri.locate_cells(cpu.tri, cc, cpu._queries(Q))
    assert (leaf.cpu() != cleaf).float().mean() < 1e-3  # edges within f32 noise
    torch.testing.assert_close(ok.cpu(), cok, rtol=0, atol=0)


_FACADES = {}


def _facade_20k():
    """The card's float32 device-engine facade of 20,000 uniform sites (T =
    40,001, past the brute-force limit), built once per process."""
    if "20k" not in _FACADES:
        sites = np.random.default_rng(5).uniform(-0.5, 0.5, size=(20_000, 2))
        vals = np.sin(6 * sites[:, 0]) * np.cos(6 * sites[:, 1])
        _FACADES["20k"] = ScatteredInterp(sites, vals, flags=host_tree.NOSTANDARDIZE,
                                          engine="device", dtype=torch.float32)
    return _FACADES["20k"]


def _cell_queries(n, device):
    """n queries uniform over the square, then queries outside it and
    outside the cage."""
    rng = np.random.default_rng(n)
    far = rng.uniform(-4.0, 4.0, size=(n // 10, 2))
    edge = [[1e7, 1e7], [-3.0, 0.2], [0.5, -0.5], [-0.5, 0.5], [0.0, 0.0], [-1e7, 3.0]]
    q = np.concatenate([rng.uniform(-0.5, 0.5, size=(n, 2)), far, edge])
    return torch.as_tensor(q, dtype=torch.float32, device=device)


def _cells_kernel_equals_plain(tri, cells, q):
    """The cell kernel's (leaf, weights, in_domain, bad) against its plain
    version's, to the bit; returns the kernel's."""
    before = cells_ops.cells2d_cuda.launches
    got = cells_ops.cells2d_cuda(q, tri.shift, tri.scale, cells.table, cells.overflow,
                                 tri.affine, cells.res, cells.k, cells.complete)
    want = device_tri._locate_cells_score_2d(tri, cells, q)
    torch.cuda.synchronize()
    assert cells_ops.cells2d_cuda.launches == before + 1
    for name, g, p in zip(("leaf", "w", "in_domain", "bad"), got, want):
        torch.testing.assert_close(g, p, rtol=0, atol=0, msg=name)
    return got


@pytest.mark.parametrize("index", ["facade", "host", "overflow", "incomplete"])
def test_cells_kernel_equals_plain(cuda, index):
    # At 2*10^5 queries (and queries outside the square and the cage): the
    # 20,000-site facade's own index (the device build, which drops a few
    # pairs on the card: incomplete), the host rasterizer's (complete),
    # the host's at K = 2 (most cells overflow), and a budget-spilled
    # device index.
    si = _facade_20k()
    cells = {"facade": si._get_cells,
             "host": lambda: device_tri.build_cell_index(si.tri, method="host"),
             "overflow": lambda: device_tri.build_cell_index(si.tri, K=2, method="host"),
             "incomplete": lambda: device_tri._build_cell_index_device(
                 si.tri, pair_budget_override=1)}[index]()
    assert index == "facade" or cells.complete == (index != "incomplete")
    assert cells.table.device.type == "cuda"
    assert index != "overflow" or float(cells.overflow.float().mean()) > 0.5
    _, _, ok, bad = _cells_kernel_equals_plain(si.tri, cells, _cell_queries(200_000, cuda))
    assert bool(bad.any()) and bool(ok.any()) and not bool(ok.all())


@pytest.mark.parametrize("K", [8, 15, 16, 24])
def test_cells_kernel_equals_plain_at_k(cuda, K):
    # K = 8 leaves lanes idle, K = 24 takes a second pass, odd K loads
    # slot by slot.
    si = _facade_20k()
    cells = device_tri.build_cell_index(si.tri, K=K)
    assert cells.k == K
    _cells_kernel_equals_plain(si.tri, cells, _cell_queries(100_000, cuda))


def test_cells_kernel_empty_row_ties_and_nan(cuda):
    # Three rows rewritten: every slot empty (slot 0 wins, leaf 0); the
    # containing triangle's fields copied into slots 3 and 11 under two ids
    # with the rest emptied (the lower slot wins the tie); and a NaN bias
    # in a listed slot (torch.argmax takes the NaN).
    import dataclasses

    si = _facade_20k()
    tri, cells = si.tri, si._get_cells()
    K = cells.k
    q = _cell_queries(20_000, cuda)
    _, cid = device_tri._cells_of(tri, cells.res, q)
    inside = torch.nonzero(torch.abs(q).amax(-1) < 0.45)[:, 0]
    picked = []
    for i in inside.tolist():
        if all(int(cid[i]) != int(cid[j]) for j in picked):
            picked.append(i)
        if len(picked) == 3:
            break
    e, t, n = picked
    leaf, *_ = device_tri._locate_cells_score_2d(tri, cells, q)
    table = cells.table.clone().view(-1, 7, K)
    # Empty slots: zero g, 1e30 bias, id -1.
    empty = torch.zeros(7, device=cuda)
    empty[4:6], empty[6] = 1e30, -1.0
    table[cid[e]] = empty[:, None]
    row = table[cid[t]]
    slot = int(torch.nonzero(row[6] == float(leaf[t]))[0, 0])
    fields = row[:, slot].clone()
    table[cid[t]] = empty[:, None]
    other = float((int(leaf[t]) + 1) % tri.n_tris)
    table[cid[t], :, 3], table[cid[t], :, 11] = fields, fields
    table[cid[t], 6, 11] = other
    listed = torch.nonzero(table[cid[n], 6] >= 0)[:, 0]
    nan_slot = int(listed[-1])
    table[cid[n], 4, nan_slot] = float("nan")
    cells = dataclasses.replace(cells, table=table.view(-1, 7 * K))
    got, _, _, _ = _cells_kernel_equals_plain(tri, cells, q)
    assert int(got[e]) == 0
    assert int(got[t]) == int(leaf[t])
    assert int(got[n]) == int(table[cid[n], 6, nan_slot])


def test_cells_wrapper_checks_inputs(cuda):
    si = _facade_20k()
    tri, cells = si.tri, si._get_cells()
    q = _cell_queries(1000, cuda)

    def call(**kw):
        args = dict(q=q, shift=tri.shift, scale=tri.scale, table=cells.table,
                    overflow=cells.overflow, affine=tri.affine, res=cells.res,
                    k=cells.k, complete=cells.complete)
        args.update(kw)
        return cells_ops.cells2d_cuda(**args)

    for bad_args in ({"q": q.double()}, {"q": q.cpu()}, {"q": q.t().contiguous().t()},
                     {"q": q.flatten()[1:-1].view(-1, 2)}, {"k": cells.k + 1},
                     {"res": cells.res - 1}, {"overflow": cells.overflow.to(torch.uint8)},
                     {"affine": tri.affine[:, :6].contiguous()}):
        with pytest.raises(errors.InvalidArgumentError):
            call(**bad_args)
    leaf, w, ok, bad = call(q=q[:0])
    assert leaf.shape == (0,) and w.shape == (0, 3) and ok.shape == bad.shape == (0,)
    rows = device_tri.vertex_responses(tri, si.response)
    assert rows.shape == (tri.n_tris, 4) and not bool(rows[:, 3].any())
    for bad_rows in (rows.double(), rows[:-1], rows.cpu(), rows[:, :3].contiguous(),
                     rows.flatten()[1:-3].view(-1, 4)):
        with pytest.raises(errors.InvalidArgumentError):
            call(values=bad_rows)
    vals, bad = call(q=q[:0], values=rows)
    assert vals.shape == bad.shape == (0,) and vals.dtype == torch.float32


def _facade_1m():
    """The card's float32 device-engine facade of the 1M cell's sites:
    10^6 uniform sites, grid_res 512 (T = 2,000,001), built once per
    process."""
    if "1m" not in _FACADES:
        sites = np.random.default_rng(7).uniform(-0.5, 0.5, size=(1_000_000, 2))
        vals = np.sin(6 * sites[:, 0]) * np.cos(6 * sites[:, 1])
        _FACADES["1m"] = ScatteredInterp(sites, vals, flags=host_tree.NOSTANDARDIZE,
                                         engine="device", dtype=torch.float32, grid_res=512)
    return _FACADES["1m"]


def _assert_same_bits(got, want, nan_bits=True):
    """(leaf, weights, in_domain) equal to the bit; with ``nan_bits``
    False, a NaN weight equals any NaN (the card and numpy make NaNs of
    other bits)."""
    for name, g, p in zip(("leaf", "w", "in_domain"), got, want):
        if g.dtype == torch.float32:
            if not nan_bits:
                torch.testing.assert_close(g.isnan(), p.isnan(), rtol=0, atol=0, msg=name)
                g, p = g.nan_to_num(0.0, torch.inf, -torch.inf), p.nan_to_num(0.0, torch.inf, -torch.inf)
            g, p = g.view(torch.int32), p.view(torch.int32)
        torch.testing.assert_close(g, p, rtol=0, atol=0, msg=name)


def _walk(tri, cells, q, idx, max_steps, leaf, w, ok):
    """The walk kernel on rows idx of q, in place; its largest iteration
    count.  Counted: one launch."""
    before = walk_ops.walk2d_cuda.launches
    n_max = walk_ops.walk2d_cuda(q, idx, tri.shift, tri.scale, cells.hint, cells.res,
                                 tri.tri_nbrs, tri.affine, max_steps, leaf, w, ok)
    torch.cuda.synchronize()
    assert walk_ops.walk2d_cuda.launches == before + 1
    assert n_max.dtype == torch.int32 and n_max.shape == (1,)
    return int(n_max)


@pytest.mark.parametrize("max_steps", [1, 2, 3, 5, 32, 128])
def test_walk_kernel_equals_loop_at_1m(cuda, max_steps):
    # The 1M cell's index (the device build's, incomplete): the queries
    # the cell kernel leaves to the walk, among 2*10^6 over the square,
    # 2*10^5 outside it (many outside the cage) and the edge queries.
    si = _facade_1m()
    tri, cells = si.tri, si._get_cells()
    q = _cell_queries(2_000_000, cuda)
    leaf, w, ok, bad = cells_ops.cells2d_cuda(q, tri.shift, tri.scale, cells.table,
                                              cells.overflow, tri.affine, cells.res, cells.k,
                                              cells.complete)
    idx = torch.nonzero(bad)[:, 0]
    got = [t.clone() for t in (leaf, w, ok)]
    want = [t.clone() for t in (leaf, w, ok)]
    n_max = _walk(tri, cells, q, idx, max_steps, *got)
    steps = device_tri.locate.steps
    device_tri._walk_in_loop(tri, cells, q, idx, max_steps, *want)
    _assert_same_bits(got, want)
    assert device_tri.lockstep_steps(n_max, max_steps) == device_tri.locate.steps - steps
    inner = int((torch.abs(q[idx]).amax(-1) <= 0.5).sum())
    assert inner > 300 and idx.numel() - inner > 1000  # both kinds walk
    assert n_max == max_steps + 1 or max_steps > 3  # small caps cut walks


@pytest.mark.parametrize("max_steps", [1, 32])
def test_walk_kernel_nan_and_boundary_queries(cuda, max_steps):
    # Every query walks: NaN and infinite coordinates (a NaN lands in cell
    # row or column 0), queries outside the cage and on the square's
    # corners, and uniform ones.  Against the loop from the same starts,
    # and against the plain per-query version.
    si = _facade_20k()
    tri, cells = si.tri, si._get_cells()
    nan, inf = float("nan"), float("inf")
    edge = [[nan, 0.1], [0.2, nan], [nan, nan], [inf, 0.0], [-inf, -inf], [1e7, 1e7],
            [-1e7, 3.0], [0.5, -0.5], [-0.5, 0.5], [0.0, 0.0]]
    q = torch.cat([torch.tensor(edge, device=cuda), _cell_queries(3000, cuda)])
    idx = torch.arange(len(q), device=cuda)
    got = (torch.zeros(len(q), dtype=torch.int64, device=cuda),
           torch.zeros(len(q), 3, device=cuda), torch.zeros(len(q), dtype=torch.bool, device=cuda))
    n_max = _walk(tri, cells, q, idx, max_steps, *got)
    safe = torch.nan_to_num(q, nan=-inf, posinf=inf, neginf=-inf)
    start = cells.hint[device_tri._cells_of(tri, cells.res, safe)[1]]
    steps = device_tri.locate.steps
    leaf, w, ok = device_tri.locate(tri, q, start=start, max_steps=max_steps)
    _assert_same_bits(got, (leaf, w, ok & torch.all(w > -0.5, dim=-1)))
    assert device_tri.lockstep_steps(n_max, max_steps) == device_tri.locate.steps - steps
    pleaf, pw, pok, n = walk2d_plain(q, start, tri.tri_nbrs, tri.affine, max_steps)
    _assert_same_bits([t.cpu() for t in got], (pleaf, pw, pok), nan_bits=False)
    assert int(n.max()) == n_max
    assert not bool(got[2][:7].any()) and bool(got[2][7:].any())


def test_walk_wrapper_checks_inputs(cuda):
    si = _facade_20k()
    tri, cells = si.tri, si._get_cells()
    q = _cell_queries(1000, cuda)
    B = len(q)

    def call(**kw):
        args = dict(q=q, idx=torch.arange(5, device=cuda), shift=tri.shift, scale=tri.scale,
                    hint=cells.hint, res=cells.res, nbrs=tri.tri_nbrs, affine=tri.affine,
                    max_steps=32, leaf=torch.zeros(B, dtype=torch.int64, device=cuda),
                    w=torch.zeros(B, 3, device=cuda),
                    in_domain=torch.zeros(B, dtype=torch.bool, device=cuda))
        args.update(kw)
        return walk_ops.walk2d_cuda(**args), args

    for bad_args in ({"q": q.double()}, {"q": q.cpu()}, {"q": q.t().contiguous().t()},
                     {"q": q.flatten()[1:-1].view(-1, 2)},
                     {"idx": torch.arange(5, device=cuda, dtype=torch.int32)},
                     {"res": cells.res - 1}, {"nbrs": tri.tri_nbrs.long()},
                     {"affine": tri.affine[:, :6].contiguous()},
                     {"leaf": torch.zeros(B, dtype=torch.int32, device=cuda)},
                     {"w": torch.zeros(B, 2, device=cuda)}, {"max_steps": -1}):
        with pytest.raises(errors.InvalidArgumentError):
            call(**bad_args)
    n_max, args = call(idx=torch.zeros(0, dtype=torch.int64, device=cuda))
    assert int(n_max) == 0 and not bool(args["leaf"].any())
    rows, vals = device_tri.vertex_responses(tri, si.response), torch.zeros(B, device=cuda)
    none = dict(leaf=None, w=None, in_domain=None)
    for bad_args in (dict(values=(rows, vals)),  # the outputs of both modes
                     dict(values=(rows.double(), vals), **none),
                     dict(values=(rows[:, :3].contiguous(), vals), **none),
                     dict(values=(rows, vals[:-1]), **none),
                     dict(values=(rows, vals.double()), **none)):
        with pytest.raises(errors.InvalidArgumentError):
            call(**bad_args)
    n_max, args = call(values=(rows, vals), **none)
    assert int(n_max) > 0 and bool(vals[:5].any()) and not bool(vals[5:].any())


def test_one_walk_launch_per_locate_cells_call_that_walks(cuda):
    si = _facade_20k()
    tri = si.tri
    q = _cell_queries(20_000, cuda)
    for K, walks in ((2, True), (32, False)):  # K = 2: most cells overflow
        cells = device_tri.build_cell_index(tri, K=K, method="host")
        bad = cells_ops.cells2d_cuda(q, tri.shift, tri.scale, cells.table, cells.overflow,
                                     tri.affine, cells.res, cells.k, cells.complete)[3]
        if not walks:
            q = q[~bad]  # queries the index settles
        before = walk_ops.walk2d_cuda.launches, device_tri.locate.queries
        device_tri.locate_cells(tri, cells, q)
        assert walk_ops.walk2d_cuda.launches == before[0] + walks
        assert device_tri.locate.queries - before[1] == (int(bad.sum()) if walks else 0)


def _fused_equals_plain(tri, cells, resp, q):
    """interp's fused cell route (``interp_cells_on_card``) against
    ``locate_cells`` and interp's torch tail on the card, and against the
    epilogue's emulation, to the bit: one launch of the cell kernel, one
    of the walk kernel if any row walks, none otherwise, and one fused
    eval.  Returns the number of rows walked."""
    counts = lambda: (cells_ops.cells2d_cuda.launches, walk_ops.walk2d_cuda.launches,  # noqa: E731
                      device_tri.interp.fused_evals, device_tri.locate.queries)
    before = counts()
    got = device_tri.interp(tri, resp, q, method="cells", cells=cells)
    torch.cuda.synchronize()
    cells2d, walk2d, fused, walked = (a - b for a, b in zip(counts(), before))
    assert (cells2d, walk2d, fused) == (1, int(walked > 0), 1)
    leaf, w, ok = device_tri.locate_cells(tri, cells, q)
    r = resp[tri.tri_verts[leaf]]
    want = torch.where(ok, torch.sum(w * r, dim=-1), 0.0)
    assert got.dtype == torch.float32 and got.shape == want.shape
    rows = device_tri.vertex_responses(tri, resp)
    given = device_tri.interp(tri, resp, q, method="cells", cells=cells, resp_tri=rows)
    for name, ref in (("tail", want), ("emulation", bary_values(w, r, ok)),
                      ("rows given", given)):
        torch.testing.assert_close(got.view(torch.int32), ref.view(torch.int32),
                                   rtol=0, atol=0, msg=name)
    return walked


def test_fused_eval_equals_plain_on_the_1m_pool(cuda):
    # Every batch of the 1M cell's pool (tri2d_1m.eval at one seed: 10^6
    # sites, 16 batches of 2*10^7 queries), walked rows included.
    from benchmark import generate, run
    from gsl_scattered_interpolation_torch.models import scattered

    seed = 2147600020
    _, config, traffic = run.cell_parts(run.load_spec(), "tri2d_1m.eval")
    sites, values = generate.problem(config, seed)
    si = ScatteredInterp(sites, values, flags=getattr(scattered, config["flags"]),
                         engine=config["engine"], dtype=getattr(torch, config["dtype"]),
                         grid_res=config["grid_res"], device=cuda)
    tri, cells = si.tri, si._get_cells()
    pool = generate.query_pool(config, traffic, seed, cuda)
    walked = [_fused_equals_plain(tri, cells, si.response, q) for q in pool]
    assert len(walked) == 16 and min(walked) > 1000
    fused = device_tri.interp.fused_evals
    torch.testing.assert_close(si.eval(pool[0]).view(torch.int32),
                               device_tri.interp(tri, si.response, pool[0], method="cells",
                                                 cells=cells).view(torch.int32), rtol=0, atol=0)
    assert device_tri.interp.fused_evals == fused + 2  # the facade takes it too


def _fixture_queries(tri, n, device):
    """n float32 queries over the fixture's sites' box and a margin, then
    queries outside the cage and NaN and infinite ones."""
    rng = np.random.default_rng(n)
    pts = tri.points_raw[tri.dim + 1:].double().cpu().numpy()
    lo, hi = pts.min(0), pts.max(0)
    pad = 0.1 * (hi - lo)
    nan, inf = float("nan"), float("inf")
    edge = [[1e7, 1e7], [-1e7, 3e6], [nan, 0.0], [0.0, nan], [nan, nan], [inf, 0.0]]
    q = np.concatenate([rng.uniform(lo - pad, hi + pad, size=(n, 2)), edge])
    return torch.as_tensor(q, dtype=torch.float32, device=device)


@pytest.mark.parametrize("K", [2, None])
@pytest.mark.parametrize("name", ["weather", "uniform", "cocircular"])
def test_fused_eval_equals_plain_on_fixtures(cuda, name, K):
    # The slivers' fixtures on the card, with their own index and with K =
    # 2, where most cells overflow and most queries walk.
    tri = fixture_tri(name).to(cuda)
    cells = device_tri.build_cell_index(tri, **({} if K is None else {"K": K}))
    r = np.random.default_rng(3).uniform(-2.0, 2.0, size=tri.points_raw.shape[0])
    r[:3] = 0.0  # the cage's rows
    resp = torch.as_tensor(r, dtype=torch.float32, device=cuda)
    walked = _fused_equals_plain(tri, cells, resp, _fixture_queries(tri, 20_000, cuda))
    assert walked > 0


def test_fused_eval_nan_outside_and_no_walk(cuda):
    # NaN and infinite queries and queries outside the square and the
    # cage on the 20,000-site facade; then a batch that walks nothing.
    si = _facade_20k()
    tri, cells = si.tri, si._get_cells()
    nan, inf = float("nan"), float("inf")
    edge = [[nan, 0.1], [0.2, nan], [nan, nan], [inf, 0.0], [-inf, -inf], [1e7, 1e7]]
    q = torch.cat([torch.tensor(edge, device=cuda), _cell_queries(100_000, cuda)])
    assert _fused_equals_plain(tri, cells, si.response, q) > 0
    got = device_tri.interp(tri, si.response, q, method="cells", cells=cells)
    assert not bool(got[:len(edge)].any()) and not bool(torch.signbit(got[:len(edge)]).any())
    bad = cells_ops.cells2d_cuda(q, tri.shift, tri.scale, cells.table, cells.overflow,
                                 tri.affine, cells.res, cells.k, cells.complete)[3]
    assert _fused_equals_plain(tri, cells, si.response, q[~bad].contiguous()) == 0


def test_float64_facade_on_card_keeps_every_query(cuda):
    # ROADMAP Queue C item 1: a float64 triangulation on the card must not
    # go to the float32 locate kernel, which dropped 5 of these queries.
    sites, temps = datasets.weather()
    Q = np.random.default_rng(2).uniform([-89, 41.2], [-87, 42.8], (200000, 2))
    gpu = ScatteredInterp(sites, temps, key=0, engine="host", dtype=torch.float64)
    cpu = ScatteredInterp(sites, temps, key=0, engine="host", device="cpu")
    before = locate.locate2d_cuda.launches
    v = gpu.eval(Q)
    assert locate.locate2d_cuda.launches == before
    np.testing.assert_allclose(v.cpu().numpy(), cpu.eval(Q).numpy(), rtol=0, atol=1e-9)


@pytest.mark.parametrize("budget", [None, 1])
def test_device_index_on_card_equals_cpu(cuda, budget):
    from gsl_scattered_interpolation_torch.models import device_delaunay as dd

    sites = np.random.default_rng(7).uniform(-0.5, 0.5, size=(5000, 2))
    cpu, _ = dd.triangulate(sites, flags=host_tree.NOSTANDARDIZE, device="cpu")
    ours = device_tri._build_cell_index_device(cpu.to(cuda), pair_budget_override=budget)
    ref = device_tri._build_cell_index_device(cpu, pair_budget_override=budget)
    assert ours.table.device.type == "cuda" and not ours.complete and not ref.complete
    for name in ("overflow", "hint"):
        torch.testing.assert_close(getattr(ours, name).cpu(), getattr(ref, name), rtol=0, atol=0)
    got = ours.table.cpu().reshape(-1, 7, ours.k)
    want = ref.table.reshape(-1, 7, ref.k)
    torch.testing.assert_close(got[:, 6], want[:, 6], rtol=0, atol=0)
    ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    assert int(ulps.max()) <= 1


def _std_sites(n, seed, dtype, device):
    """The build's standardized sites of n uniform sites: (numpy float64,
    cage tensor on ``device``)."""
    from gsl_scattered_interpolation_torch.models import device_delaunay as dd

    sites = np.random.default_rng(seed).uniform(-0.5, 0.5, size=(n, 2))
    *_, cage, std = dd.build_inputs(sites, flags=host_tree.NOSTANDARDIZE, dtype=dtype)
    return sites, std, cage.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chunked_seeded_build_on_card_equals_single_route(cuda, dtype):
    # 50,000 sites past a lowered chunk threshold: the Qhull seed, the
    # compacted rounds and the candidate kernel on [R] rows, against the
    # single-program route on the card.
    from gsl_scattered_interpolation_torch.models import device_delaunay as dd
    from gsl_scattered_interpolation_torch.ops import candmath

    sites = np.random.default_rng(11).uniform(-0.5, 0.5, size=(50_000, 2))
    kw = dict(flags=host_tree.NOSTANDARDIZE, dtype=dtype, device=cuda)
    stats = {}
    before = candmath.edge_candidates_math_cuda.launches
    tri, sh = dd.triangulate(sites, chunk_threshold=10_000, seed_min=10_000, stats=stats, **kw)
    launches = candmath.edge_candidates_math_cuda.launches - before
    ref, sh_ref = dd.triangulate(sites, **kw)
    assert stats["seeded"] is True and tri.tri_verts.device.type == cuda.type
    sweeps = stats["insert_sweep_rounds"] + stats["final_sweep_rounds"]
    assert launches == sweeps + stats["cleanup_sub_rounds"] > 0
    np.testing.assert_array_equal(sh, sh_ref)

    def tri_set(t):
        return {tuple(r) for r in np.sort(t.tri_verts.cpu().numpy(), axis=1).tolist()}

    assert tri.n_tris == 100_001 and tri_set(tri) == tri_set(ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_seed_walk_on_card_locates_every_site(cuda, dtype):
    # The seed's exact walk on the card leaves no site unlocated (else
    # _seed_state_2d raises) and puts every site where the CPU walk does.
    from gsl_scattered_interpolation_torch.models import device_delaunay as dd

    _, std, cage = _std_sites(50_000, 12, dtype, cuda)
    _, st, dirty = dd._seed_state_2d(std, cage)
    _, st_cpu, dirty_cpu = dd._seed_state_2d(std, cage.cpu())
    left = st.site_tri >= 0
    assert int(left.sum()) == int(st.n_left) > 40_000
    for f in ("tri_v", "tri_n", "cc", "site_tri"):
        torch.testing.assert_close(getattr(st, f).cpu(), getattr(st_cpu, f), rtol=0, atol=0)
    torch.testing.assert_close(dirty.cpu(), dirty_cpu, rtol=0, atol=0)


def test_device_grid_starts_reach_every_leaf(cuda):
    # from_arrays' device grid on the card: the same grid as the host's,
    # and a walk from its start triangles reaches every query's leaf.
    from gsl_scattered_interpolation_torch.models import device_delaunay as dd

    sites = np.random.default_rng(13).uniform(-0.5, 0.5, size=(50_000, 2))
    tri, _ = dd.triangulate(sites, flags=host_tree.NOSTANDARDIZE, grid_res=128, device=cuda)
    host = device_tri._bucket_grid(
        tri.points_std.cpu().numpy(), tri.tri_verts.cpu().numpy(), 128
    )
    np.testing.assert_array_equal(tri.grid_tri.cpu().numpy(), host)
    tri32 = tri.cast(torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(14)
    q = torch.rand(200_000, 2, generator=gen, device=cuda) - 0.5
    leaf, w, ok = device_tri.locate(tri32, q, max_steps=512)
    assert bool(ok.all())
    assert bool((w >= -1e-5).all())  # each leaf holds its query within f32 noise
    dense, _, _ = device_tri.locate_dense(tri32, q)
    assert (leaf != dense).float().mean() < 1e-3  # ties on shared edges


def _canon(tv):
    return {tuple(sorted(r)) for r in tv.tolist()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cavity_build_on_card_equals_cpu(cuda, dtype):
    # The 3D cavity build, seeded (3,000 sites, seed_min lowered: 2,400
    # seeded, 600 inserted by rounds), on the card and on the CPU: the same
    # tetrahedra, the same rounds, and no launch of either kernel.
    from gsl_scattered_interpolation_torch.models import device_cavity as dc
    from gsl_scattered_interpolation_torch.ops import candmath

    sites = np.random.default_rng(5).uniform(-0.5, 0.5, size=(3000, 3))
    stats = {}, {}
    before = locate.locate2d_cuda.launches, candmath.edge_candidates_math_cuda.launches
    ours, _ = dc.triangulate(sites, flags=host_tree.NOSTANDARDIZE, dtype=dtype, seed_min=64,
                             device=cuda, stats=stats[0])
    ref, _ = dc.triangulate(sites, flags=host_tree.NOSTANDARDIZE, dtype=dtype, seed_min=64,
                            device="cpu", stats=stats[1])
    assert (locate.locate2d_cuda.launches, candmath.edge_candidates_math_cuda.launches) == before
    assert ours.tri_verts.device.type == "cuda"
    assert _canon(ours.tri_verts.cpu()) == _canon(ref.tri_verts)
    for key in ("seed_sites", "seed_left_out", "winners", "cavity_cap"):
        assert stats[0][key] == stats[1][key], key
    torch.testing.assert_close(ours.grid_tri.cpu(), ref.grid_tri, rtol=0, atol=0)


@pytest.mark.parametrize("packed", [True, False])
def test_cell_index_3d_on_card_equals_cpu(cuda, monkeypatch, packed):
    # The 3D device index on the card against the same build on the CPU,
    # in both layouts, and the 3D query path through it.
    from gsl_scattered_interpolation_torch.models import device_cavity as dc

    if not packed:
        monkeypatch.setattr(device_tri, "CELLS3D_PACKED_BYTES", 0)
    sites = np.random.default_rng(9).uniform(-0.5, 0.5, size=(3000, 3))
    cpu, sh = dc.triangulate(sites, flags=host_tree.NOSTANDARDIZE, device="cpu")
    ours = device_tri._build_cell_index_device(cpu.to(cuda))
    ref = device_tri._build_cell_index_device(cpu)
    assert (ours.rows is None) == packed == (ref.rows is None)
    assert (ours.n_bad, ours.n_pairs, ours.complete) == (ref.n_bad, ref.n_pairs, ref.complete)
    for name in ("overflow", "hint") + (() if packed else ("table", "rows")):
        torch.testing.assert_close(getattr(ours, name).cpu(), getattr(ref, name), rtol=0, atol=0)
    if packed:
        got = ours.table.cpu().reshape(-1, 13, ours.k)
        want = ref.table.reshape(-1, 13, ref.k)
        torch.testing.assert_close(got[:, 12], want[:, 12], rtol=0, atol=0)
        ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
        assert int(ulps.max()) <= 1
    resp = device_tri.response_for_build(sh, np.cos(3 * sites[:, 0]) + sites[:, 2], d=3, device="cpu")
    q = torch.as_tensor(np.random.default_rng(10).uniform(-0.45, 0.45, size=(50_000, 3)))
    want = device_tri.interp(cpu, resp, q, method="cells", cells=ref)
    got = device_tri.interp(cpu.to(cuda), resp.to(cuda), q.to(cuda), method="cells", cells=ours)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-9)


def _rbf_problem(n, seed):
    sites = np.random.default_rng(seed).uniform(-1, 1, size=(n, 2))
    return sites, np.sin(3 * sites[:, 0]) * np.cos(2 * sites[:, 1]) + sites[:, 1]


def test_compact_rbf_on_card_equals_cpu(cuda):
    from gsl_scattered_interpolation_torch.models import rbf_compact

    sites, vals = _rbf_problem(3000, 41)
    kw = dict(tol=1e-12, maxiter=3000, dtype=torch.float64)
    ours = rbf_compact.CompactRbf(sites, vals, device=cuda, **kw)
    ref = rbf_compact.CompactRbf(sites, vals, device="cpu", **kw)
    torch.testing.assert_close(ours.lam.cpu(), ref.lam, rtol=0, atol=1e-8)
    q = np.random.default_rng(42).uniform(-1, 1, size=(5000, 2))
    torch.testing.assert_close(ours.eval(q).cpu(), ref.eval(q), rtol=0, atol=1e-9)
    assert float(ours.residual()) < 1e-9


def test_rbf_pu_on_card_equals_cpu(cuda):
    from gsl_scattered_interpolation_torch.models import rbf_pu

    sites, vals = _rbf_problem(5000, 43)
    ours = rbf_pu.fit(sites, vals, dtype=torch.float64, device=cuda)
    ref = rbf_pu.fit(sites, vals, dtype=torch.float64, device="cpu")
    q = np.random.default_rng(44).uniform(-1, 1, size=(5000, 2))
    torch.testing.assert_close(rbf_pu.evaluate(ours, q).cpu(), rbf_pu.evaluate(ref, q),
                               rtol=0, atol=1e-8)
    got = rbf_pu.evaluate(ours, sites).cpu().numpy()
    np.testing.assert_allclose(got, vals, rtol=0, atol=1e-8)


def test_local_kriging_on_card_equals_cpu(cuda):
    from gsl_scattered_interpolation_torch.models import kriging

    sites, vals = _rbf_problem(20_000, 45)
    vg = kriging.Variogram("spherical", nugget=0.01, sill=1.0, range_=0.4)
    ours = kriging.LocalKriging(sites, vals, variogram=vg, dtype=torch.float64, device=cuda)
    ref = kriging.LocalKriging(sites, vals, variogram=vg, dtype=torch.float64, device="cpu")
    q = np.random.default_rng(46).uniform(-1, 1, size=(20_000, 2))
    m, v = ours.predict(q, chunk=8192)
    m_c, v_c = ref.predict(q, chunk=8192)
    torch.testing.assert_close(m.cpu(), m_c, rtol=0, atol=1e-8)
    torch.testing.assert_close(v.cpu(), v_c, rtol=0, atol=1e-8)
    # the auto-fitted variogram on the card is the CPU's
    auto = kriging.LocalKriging(sites, vals, device=cuda)
    auto_c = kriging.LocalKriging(sites, vals, device="cpu")
    for a, b in zip(auto.variogram[1:], auto_c.variogram[1:]):
        assert a == pytest.approx(b, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m", [(4096, 1), (4096, 64), (1, 3), (2, 1), (9, 65), (1000, 130)])
def test_tridiag_kernel_equals_plain(cuda, dtype, n, m):
    from gsl_scattered_interpolation_torch.ops import tridiag

    gen = torch.Generator(device=cuda).manual_seed(n + m)
    d = (torch.rand(n, generator=gen, device=cuda, dtype=dtype) + 3.0).contiguous()
    e = (torch.rand(max(n - 1, 0), generator=gen, device=cuda, dtype=dtype) * 2 - 1).contiguous()
    b = torch.randn(n, m, generator=gen, device=cuda, dtype=dtype)
    before = tridiag.thomas_cuda.launches
    got = tridiag.thomas_cuda(d, e, b)
    torch.cuda.synchronize()
    assert tridiag.thomas_cuda.launches == before + 1
    assert got.shape == (n, m) and got.dtype == dtype
    torch.testing.assert_close(got, tridiag.thomas_ref(d, e, b), rtol=0, atol=0)
    # The plain version on the CPU gives the same bits.
    torch.testing.assert_close(got.cpu(), tridiag.thomas_ref(d.cpu(), e.cpu(), b.cpu()),
                               rtol=0, atol=0)


def test_tridiag_wrapper_checks_inputs(cuda):
    from gsl_scattered_interpolation_torch.ops import tridiag

    d = torch.ones(5, device=cuda) * 4
    e = torch.ones(4, device=cuda)
    b = torch.ones(5, 2, device=cuda)
    with pytest.raises(errors.InvalidArgumentError):
        tridiag.thomas_cuda(d.double(), e, b)
    with pytest.raises(errors.InvalidArgumentError):
        tridiag.thomas_cuda(d, e[:3], b)
    with pytest.raises(errors.InvalidArgumentError):
        tridiag.thomas_cuda(d, e, b[:, 0])
    with pytest.raises(errors.InvalidArgumentError):
        tridiag.thomas_cuda(d, e, torch.ones(2, 5, device=cuda).T)
    assert tridiag.thomas_cuda(d, e, b[:, :0]).shape == (5, 0)


def _spline_system(n, m, dtype, device, seed):
    """A natural cubic spline's system on knot gaps in [0.5, 1.5], m
    right-hand sides."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h = torch.rand(n + 1, generator=gen, device=device, dtype=dtype) + 0.5
    d = (2.0 * (h[1:] + h[:-1])).contiguous()
    e = h[1:-1].contiguous()
    b = torch.randn(n, m, generator=gen, device=device, dtype=dtype)
    return d, e, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m", [(4096, 1), (100_003, 1), (2046, 2048), (100_003, 2)])
def test_partitioned_kernel_equals_plain(cuda, dtype, n, m):
    from gsl_scattered_interpolation_torch.ops import tridiag

    d, e, b = _spline_system(n, m, dtype, cuda, n + m)
    before = tridiag.partitioned_cuda.launches
    kernels = tridiag.partitioned_cuda.kernel_launches
    got = tridiag.partitioned_cuda(d, e, b)
    torch.cuda.synchronize()
    assert tridiag.partitioned_cuda.launches == before + 1
    assert tridiag.partitioned_cuda.kernel_launches == kernels + tridiag.kernels_per_solve(n, m)
    assert got.shape == (n, m) and got.dtype == dtype
    torch.testing.assert_close(got, tridiag.partitioned_ref(d, e, b), rtol=0, atol=0)
    torch.testing.assert_close(got.cpu(), tridiag.partitioned_ref(d.cpu(), e.cpu(), b.cpu()),
                               rtol=0, atol=0)
    # and the sequential route's solution, within the CPU tests' tolerance
    seq = tridiag.thomas_cuda(d, e, b)
    tol = 1e-14 if dtype == torch.float64 else 4 * torch.finfo(dtype).eps
    assert float((got - seq).abs().max()) <= tol * float(seq.abs().max())


# Level boundaries of BLOCK = 32: one row past a level, a tile (32 blocks)
# and one more block, two and three levels with ragged tails.
@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("n", [33, 1024, 1057, 32 * 32 * 32 + 1, 70_001])
def test_partitioned_levels_equal_plain(cuda, n, m):
    from gsl_scattered_interpolation_torch.ops import tridiag

    for dtype in (torch.float32, torch.float64):
        d, e, b = _spline_system(n, m, dtype, cuda, 7 * n + m)
        got = tridiag.partitioned_cuda(d, e, b)
        torch.testing.assert_close(got, tridiag.partitioned_ref(d, e, b), rtol=0, atol=0)


def test_partitioned_wrapper_checks_inputs(cuda):
    from gsl_scattered_interpolation_torch.ops import tridiag

    d = torch.ones(500, device=cuda) * 4
    e = torch.ones(499, device=cuda)
    b = torch.ones(500, 2, device=cuda)
    with pytest.raises(errors.InvalidArgumentError):
        tridiag.partitioned_cuda(d.double(), e, b)
    with pytest.raises(errors.InvalidArgumentError):
        tridiag.partitioned_cuda(d, e[:3], b)
    with pytest.raises(errors.InvalidArgumentError):
        tridiag.partitioned_cuda(d, e, b[:, 0])
    with pytest.raises(errors.InvalidArgumentError):
        tridiag.partitioned_cuda(d, e, torch.ones(2, 500, device=cuda).T)
    assert tridiag.partitioned_cuda(d, e, b[:, :0]).shape == (500, 0)


def _solves():
    """Tridiagonal solves launched on the card so far, by either route."""
    from gsl_scattered_interpolation_torch.ops import tridiag

    return tridiag.thomas_cuda.launches + tridiag.partitioned_cuda.launches


def test_interp1d_on_card_matches_cpu(cuda):
    from gsl_scattered_interpolation_torch.models import interp1d

    rng = np.random.default_rng(47)
    for kind in sorted(interp1d.TYPES):
        n = 12 if kind == "polynomial" else 3000
        x = np.cumsum(rng.uniform(0.5, 1.5, n))
        y = rng.normal(size=n)
        if kind.endswith("periodic"):
            y[-1] = y[0]
        before = _solves()
        ours = interp1d.Interp1D(x, y, kind, device=cuda, dtype=torch.float64)
        ref = interp1d.Interp1D(x, y, kind, device="cpu", dtype=torch.float64)
        assert _solves() == before + (kind.startswith("cspline"))
        q = np.concatenate([rng.uniform(x[0] - 1, x[-1] + 1, 20_000), x])
        for op in ("eval", "eval_deriv", "eval_deriv2"):
            a, b = getattr(ours, op)(q).cpu(), getattr(ref, op)(q)
            assert torch.equal(torch.isnan(a), torch.isnan(b)), (kind, op)
            scale = max(1.0, float(b.nan_to_num().abs().max()))
            torch.testing.assert_close(a, b, rtol=0, atol=1e-12 * scale, equal_nan=True)
        a, b = ours.eval_integ(x[0], q).cpu(), ref.eval_integ(x[0], q)
        scale = max(1.0, float(b.nan_to_num().abs().max()))
        if kind == "polynomial":
            # The monomial form's terms cancel: hold the integral to their
            # magnitude (tests/test_torch_interp1d.py).
            mono = interp1d._poly_monomial(ref.dd, ref.x)
            k = torch.arange(mono.numel(), dtype=mono.dtype) + 1.0
            t = torch.tensor(np.concatenate([q, [x[0]]]))
            scale = float((mono * t[:, None] ** k / k).abs().sum(-1).max()) * 2
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12 * scale, equal_nan=True)


def test_interp2d_on_card_matches_cpu(cuda):
    from gsl_scattered_interpolation_torch.models import interp2d

    rng = np.random.default_rng(48)
    x = np.cumsum(rng.uniform(0.5, 1.5, 200))
    y = np.cumsum(rng.uniform(0.5, 1.5, 150))
    z = np.sin(0.1 * x)[:, None] * np.cos(0.07 * y)[None, :] + rng.normal(size=(200, 150)) * 0.01
    xq = rng.uniform(x[0] - 1, x[-1] + 1, 50_000)
    yq = rng.uniform(y[0] - 1, y[-1] + 1, 50_000)
    for kind in ("bilinear", "bicubic"):
        before = _solves()
        ours = interp2d.Interp2D(x, y, z, kind, device=cuda, dtype=torch.float64)
        ref = interp2d.Interp2D(x, y, z, kind, device="cpu", dtype=torch.float64)
        assert _solves() == before + 3 * (kind == "bicubic")
        for op in ("eval", "eval_extrap", "eval_deriv_x", "eval_deriv_y", "eval_deriv_xx",
                   "eval_deriv_xy", "eval_deriv_yy"):
            a, b = getattr(ours, op)(xq, yq).cpu(), getattr(ref, op)(xq, yq)
            scale = max(1.0, float(b.nan_to_num().abs().max()))
            torch.testing.assert_close(a, b, rtol=0, atol=1e-12 * scale, equal_nan=True)


@pytest.fixture
def nccl_rank(cuda):
    """This process as the one rank of an NCCL group, left again after the
    test."""
    from gsl_scattered_interpolation_torch.parallel import launch

    launch.init_group(0, 1, device="cuda")
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_sharded_paths_at_one_rank_equal_single_process(nccl_rank):
    from gsl_scattered_interpolation_torch.models import rbf
    from gsl_scattered_interpolation_torch.parallel import mesh as pmesh, sharding

    mesh = pmesh.make_mesh(device="cuda")
    assert torch.distributed.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1)
    tri = _tri(1500, 3, "cuda")
    resp = torch.rand(tri.points_raw.shape[0], generator=torch.Generator().manual_seed(3)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(4)
    q = torch.rand(70_001, 2, generator=gen, device="cuda") * 1.2 - 0.6
    before = locate.locate2d_cuda.launches
    got = sharding.interp_sharded(tri, resp, q, mesh)
    torch.cuda.synchronize()
    assert locate.locate2d_cuda.launches == before + 1
    torch.testing.assert_close(got, device_tri.interp(tri, resp, q), rtol=0, atol=0)

    rng = np.random.default_rng(1)
    sites = rng.uniform(-0.5, 0.5, size=(384, 2))
    values = np.sin(4 * sites[:, 0]) + sites[:, 1]
    lam = sharding.rbf_fit_cg_sharded(sites, values, mesh, epsilon=6.0, tol=1e-12,
                                      maxiter=2000)
    ref, _ = rbf._cg_matfree(torch.tensor(sites, device="cuda"),
                             torch.tensor(values, device="cuda"),
                             rbf.KERNELS["wendland_c2"].phi, 6.0, 0.0, 1e-12, 2000, 4096)
    torch.testing.assert_close(lam, ref, rtol=0, atol=1e-10)
