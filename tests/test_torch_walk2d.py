"""The walk kernel's semantics (``tests/walk2d_emulation.py::walk2d_plain``,
query by query as ``kernels/csrc/walk2d.cu`` walks) against the lockstep
loop of ``models/device_tri.locate``, and the 2D cell route's value
epilogue (``bary_values``, as ``kernels/csrc/bary2d.cuh`` computes) and
its route in ``device_tri.interp``, on the CPU.  No JAX."""

import numpy as np
import pytest
import torch
from walk2d_emulation import bary_values, fixture_tri, walk2d_plain

from gsl_scattered_interpolation_torch.models import device_tri as dt
from gsl_scattered_interpolation_torch.models import host_tree
from gsl_scattered_interpolation_torch.ops import cells as cells_ops
from gsl_scattered_interpolation_torch.ops import walk as walk_ops
from gsl_scattered_interpolation_torch.utils import errors


def _queries(tri, n, seed):
    """n float32 queries over the sites' box and a margin, then queries
    outside the cage and one NaN query, with random starts (so walks run
    long and small caps stop them midway)."""
    rng = np.random.default_rng(seed)
    pts = tri.points_raw[tri.dim + 1:].double().numpy()
    lo, hi = pts.min(0), pts.max(0)
    pad = 0.1 * (hi - lo)
    q = np.concatenate([rng.uniform(lo - pad, hi + pad, size=(n, 2)),
                        [[1e7, 1e7], [-1e7, 3e6], [np.nan, 0.0]]])
    start = rng.integers(0, tri.n_tris, size=len(q))
    return torch.as_tensor(q, dtype=torch.float32), torch.as_tensor(start)


@pytest.mark.parametrize("max_steps", [1, 2, 3, 5, 32, 128])
@pytest.mark.parametrize("name", ["weather", "uniform", "cocircular"])
def test_plain_walk_equals_loop(name, max_steps):
    tri = fixture_tri(name)
    q, start = _queries(tri, 150, seed=max_steps)
    steps = dt.locate.steps
    leaf, w, ok = dt.locate(tri, q, start=start, max_steps=max_steps)
    steps = dt.locate.steps - steps
    pleaf, pw, pok, n = walk2d_plain(q, start, tri.tri_nbrs, tri.affine, max_steps)
    torch.testing.assert_close(pleaf, leaf, rtol=0, atol=0)
    torch.testing.assert_close(pw.view(torch.int32), w.view(torch.int32), rtol=0, atol=0)
    torch.testing.assert_close(pok, ok & torch.all(w > -0.5, dim=-1), rtol=0, atol=0)
    assert dt.lockstep_steps(int(n.max()), max_steps) == steps
    assert int(n.min()) >= 1 and int(n.max()) <= max_steps + 1
    assert bool(torch.isnan(pw[-1]).all()) and not bool(pok[-3:].any())
    if max_steps <= 3:
        assert int(n.max()) == max_steps + 1  # some walks are cut midway
    else:
        assert int(n.max()) > 3  # some walks run long


def test_cpu_walk_takes_the_loop():
    # Off the card the cell route walks in the loop; the kernel's wrapper
    # refuses CPU tensors.
    tri = fixture_tri("uniform")
    cells = dt.build_cell_index(tri, K=2)  # most cells overflow: many walk
    q, _ = _queries(tri, 500, seed=7)
    q = q[:-1]  # the NaN query has no cell off the card
    before = walk_ops.walk2d_cuda.launches, dt.locate.queries
    dt.locate_cells(tri, cells, q)
    assert walk_ops.walk2d_cuda.launches == before[0]
    assert dt.locate.queries > before[1]
    leaf, w, ok = (torch.zeros(len(q), dtype=torch.int64), torch.zeros(len(q), 3),
                   torch.zeros(len(q), dtype=torch.bool))
    with pytest.raises(errors.InvalidArgumentError):
        walk_ops.walk2d_cuda(q, torch.arange(3), tri.shift, tri.scale, cells.hint, cells.res,
                             tri.tri_nbrs, tri.affine, 32, leaf, w, ok)


def _responses(tri, seed=0):
    """float32 responses of the triangulation's vertices, 0 on the cage's
    rows as ``reindex_response`` gives them."""
    r = np.random.default_rng(seed).uniform(-2.0, 2.0, size=tri.points_raw.shape[0])
    r[: tri.dim + 1] = 0.0
    return torch.as_tensor(r, dtype=tri.dtype)


def _tail(tri, resp, leaf, w, ok):
    """``device_tri.interp``'s plain tail after a locate."""
    return torch.where(ok, torch.sum(w * resp[tri.tri_verts[leaf]], dim=-1), 0.0)


@pytest.mark.parametrize("name", ["weather", "uniform", "cocircular"])
def test_epilogue_emulation_equals_the_tail(name):
    # On the cell route's answers (walked rows and out-of-cage queries
    # among them): the epilogue is torch.sum over the products taken in
    # the card's order, to the bit, and the CPU's plain tail, which sums
    # in the order (p0 + p1) + p2, to within an ulp of max|r|.
    tri = fixture_tri(name)
    cells = dt.build_cell_index(tri, K=2)  # most cells overflow: many walk
    resp = _responses(tri)
    q = _queries(tri, 3000, seed=5)[0][:-1]  # the NaN query has no cell off the card
    queries = dt.locate.queries
    leaf, w, ok = dt.locate_cells(tri, cells, q)
    assert dt.locate.queries > queries and bool(ok.any()) and not bool(ok.all())
    r = resp[tri.tri_verts[leaf]]
    got = bary_values(w, r, ok)
    card_order = torch.where(ok, torch.sum((w * r)[:, [0, 2, 1]], dim=-1), 0.0)
    torch.testing.assert_close(got, card_order, rtol=0, atol=0)
    tail = _tail(tri, resp, leaf, w, ok)
    ulp = float(np.spacing(resp.abs().max().numpy()))
    assert float((got - tail).abs().max()) <= ulp
    torch.testing.assert_close(got, dt.interp(tri, resp, q, method="cells", cells=cells),
                               rtol=0, atol=ulp)
    assert not bool(torch.signbit(got[~ok]).any())  # +0 outside the domain


F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("args,fused", [
    (("cuda", 2, F32, F32, F32, F32), True),
    (("cuda", 2, F32, F32, F32), True),  # locate_cells' own test
    (("cpu", 2, F32, F32, F32, F32), False),
    (("cuda", 3, F32, F32, F32, F32), False),
    (("cuda", 2, F64, F32, F32, F32), False),  # float64 queries
    (("cuda", 2, F32, F32, F64, F32), False),  # a float64 triangulation
    (("cuda", 2, F32, F32, F32, F64), False),  # float64 responses
])
def test_cells_on_card_route(args, fused):
    assert dt.cells_on_card(*args) is fused


def _3d_fixture():
    sites = np.random.default_rng(3).uniform(-0.5, 0.5, size=(300, 3))
    tree = host_tree.build(sites, flags=host_tree.NOSTANDARDIZE)
    return dt.freeze(tree, device="cpu")


@pytest.mark.parametrize("case", ["float32", "float64", "3d"])
def test_interp_off_the_card_keeps_the_plain_tail(monkeypatch, case):
    # Off the card, in float64 and in 3D, interp's cell route locates and
    # then gathers and sums in torch: the fused route is never taken.
    def refuse(*args, **kwargs):
        raise AssertionError("the fused route was taken")

    monkeypatch.setattr(dt, "interp_cells_on_card", refuse)
    monkeypatch.setattr(cells_ops, "cells2d_cuda", refuse)
    monkeypatch.setattr(walk_ops, "walk2d_cuda", refuse)
    if case == "3d":
        tri = _3d_fixture()
        q = torch.as_tensor(np.random.default_rng(4).uniform(-0.6, 0.6, size=(500, 3)))
    else:
        tri = fixture_tri("uniform").cast(getattr(torch, case))
        q = _queries(tri, 500, seed=6)[0][:-1].to(tri.dtype)
    cells = dt.build_cell_index(tri, K=2)
    resp = _responses(tri)
    fused = dt.interp.fused_evals
    got = dt.interp(tri, resp, q, method="cells", cells=cells)
    rows = dt.vertex_responses(tri, resp)
    given = dt.interp(tri, resp, q, method="cells", cells=cells, resp_tri=rows)
    assert dt.interp.fused_evals == fused
    assert rows.shape == (tri.n_tris, 4)  # in 3D d + 1 = 4, in 2D a zero column
    want = _tail(tri, resp, *dt.locate_cells(tri, cells, q))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(given, want, rtol=0, atol=0)


@pytest.mark.parametrize("walks", [True, False])
@pytest.mark.parametrize("name", ["weather", "uniform", "cocircular"])
def test_fused_route_on_emulated_kernels(monkeypatch, name, walks):
    # interp_cells_on_card's own logic (the select read, the walk of the
    # rows it names into the same values, the spans' counters) with the
    # two kernels' value modes emulated on the CPU: the values of
    # locate_cells and the epilogue, one launch of each kernel (none of
    # the walk's where nothing walks), one fused eval.
    tri = fixture_tri(name)
    cells = dt.build_cell_index(tri, K=2)
    resp = _responses(tri, seed=1)
    q = _queries(tri, 2000, seed=8)[0][:-1]
    bad = dt._locate_cells_score_2d(tri, cells, q)[3]
    if not walks:
        q = q[~bad]  # queries the index settles
    n_walk = int(bad.sum()) if walks else 0
    assert n_walk > 100 or not walks
    leaf, w, ok = dt.locate_cells(tri, cells, q)
    want = bary_values(w, resp[tri.tri_verts[leaf]], ok)
    launches = {"cells2d": 0, "walk2d": 0}

    def cells2d(q, shift, scale, table, overflow, affine, res, k, complete, values=None):
        launches["cells2d"] += 1
        leaf, w, ok, bad = dt._locate_cells_score_2d(tri, cells, q)
        return bary_values(w, values[leaf, :3], ok), bad

    def walk2d(q, idx, shift, scale, hint, res, nbrs, affine, max_steps, leaf, w, in_domain,
               values=None):
        launches["walk2d"] += 1
        assert leaf is None and w is None and in_domain is None
        resp_rows, vals = values
        start = hint[dt._cells_of(tri, res, q[idx])[1]]
        pleaf, pw, pok, n = walk2d_plain(q[idx], start, nbrs, affine, max_steps)
        vals[idx] = bary_values(pw, resp_rows[pleaf, :3], pok)
        return n.max().to(torch.int32).reshape(1)

    monkeypatch.setattr(dt, "cells_on_card", lambda device_type, dim, *dtypes: dim == 2)
    monkeypatch.setattr(cells_ops, "cells2d_cuda", cells2d)
    monkeypatch.setattr(walk_ops, "walk2d_cuda", walk2d)
    before = (dt.interp.fused_evals, dt.locate_cells_host_reads, dt.locate.host_reads,
              dt.locate.queries)
    got = dt.interp(tri, resp, q, method="cells", cells=cells)
    after = (dt.interp.fused_evals, dt.locate_cells_host_reads, dt.locate.host_reads,
             dt.locate.queries)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert launches == {"cells2d": 1, "walk2d": int(walks)}
    assert [a - b for a, b in zip(after, before)] == [1, 1, int(walks), n_walk]


@pytest.mark.parametrize("module", [cells_ops, walk_ops])
def test_launcher_argtypes_match_the_sources(monkeypatch, module):
    # The ctypes signature of each launcher, parameter by parameter,
    # against its extern "C" declaration in the .cu file.
    import ctypes
    import re
    import types

    from gsl_scattered_interpolation_torch.kernels import build

    name = module.KERNEL
    src = (build.CSRC / f"{name}.cu").read_text()
    params = re.search(rf'extern "C" int {name}_launch\((.*?)\)\s*{{', src, re.S).group(1)
    kinds = [ctypes.c_void_p if "*" in p else {"int": ctypes.c_int, "float": ctypes.c_float}[
        p.split()[0]] for p in params.split(",")]
    fake = types.SimpleNamespace(**{f"{name}_launch": types.SimpleNamespace()})
    monkeypatch.setattr(build, "load", lambda kernel: fake)
    module._launcher.cache_clear()
    try:
        assert module._launcher().argtypes == kinds
    finally:
        module._launcher.cache_clear()


def test_fused_route_takes_the_rows_alone(monkeypatch):
    # interp(tri, None, q, resp_tri=rows) as for the plain tail: the fused
    # route reads the given rows and needs no per-vertex responses.
    tri = fixture_tri("uniform")
    cells = dt.build_cell_index(tri)
    rows = dt.vertex_responses(tri, _responses(tri))
    q = _queries(tri, 300, seed=9)[0][:-1]
    seen = []
    monkeypatch.setattr(dt, "cells_on_card", lambda device_type, dim, *dtypes: True)
    monkeypatch.setattr(dt, "interp_cells_on_card",
                        lambda tri, resp_rows, q_raw, cells: seen.append(resp_rows) or q_raw[:, 0])
    dt.interp(tri, None, q, method="cells", cells=cells, resp_tri=rows)
    assert len(seen) == 1 and seen[0] is rows
