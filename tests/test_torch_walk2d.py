"""The walk kernel's semantics (``tests/walk2d_emulation.py::walk2d_plain``,
query by query as ``kernels/csrc/walk2d.cu`` walks) against the lockstep
loop of ``models/device_tri.locate``, on the CPU.  No JAX."""

import functools

import numpy as np
import pytest
import torch
from walk2d_emulation import walk2d_plain

from gsl_scattered_interpolation_torch.models import device_tri as dt
from gsl_scattered_interpolation_torch.models import host_tree
from gsl_scattered_interpolation_torch.ops import walk as walk_ops
from gsl_scattered_interpolation_torch.utils import datasets, errors


@functools.cache
def _tri(name):
    """A float32 triangulation with slivers: the weather stations, uniform
    sites, or a jittered grid (its quads near-cocircular) inside a ring of
    near-cocircular sites (a fan of slivers along it)."""
    rng = np.random.default_rng(11)
    if name == "weather":
        tree = host_tree.build(datasets.weather()[0], key=0)
    elif name == "uniform":
        tree = host_tree.build(rng.uniform(-0.5, 0.5, size=(600, 2)),
                               flags=host_tree.NOSTANDARDIZE)
    else:
        g = np.linspace(-0.3, 0.3, 12)
        grid = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
        angle = np.linspace(0, 2 * np.pi, 96, endpoint=False)
        ring = 0.45 * np.stack([np.cos(angle), np.sin(angle)], -1)
        sites = np.concatenate([grid, ring]) + rng.normal(scale=1e-7, size=(240, 2))
        tree = host_tree.build(sites, flags=host_tree.NOSTANDARDIZE)
    return dt.freeze(tree, device="cpu").cast(torch.float32)


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
    tri = _tri(name)
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
    tri = _tri("uniform")
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
