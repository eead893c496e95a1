"""The 2D cell route's kernel arithmetic, emulated on the CPU.

``kernels/csrc/walk2d.cu`` walks each query alone; :func:`walk2d_plain`
repeats that walk step for step, iteration count included, so that
``tests/test_torch_walk2d.py`` can hold the kernel's semantics to the
lockstep loop of ``models/device_tri.py::locate`` without a card, and the
card tests and ``chip_smoke.py --walk2d`` can hold the kernel to it.
:func:`bary_values` is the value epilogue that both ``cells2d.cu`` and
``walk2d.cu`` run in value mode (``kernels/csrc/bary2d.cuh``), and
:func:`fixture_tri` the float32 triangulations with slivers that the CPU
and card tests share.  The port itself keeps only the kernels' wrappers
(``ops/cells.py``, ``ops/walk.py``) and their plain versions.  Imports
torch, numpy and the port only.
"""

import functools

import numpy as np
import torch

from gsl_scattered_interpolation_torch.models import device_tri, host_tree
from gsl_scattered_interpolation_torch.ops.walk import TOL
from gsl_scattered_interpolation_torch.utils import datasets


@functools.cache
def fixture_tri(name):
    """A float32 triangulation on the CPU with slivers: the weather
    stations, uniform sites, or a jittered grid (its quads near-cocircular)
    inside a ring of near-cocircular sites (a fan of slivers along it)."""
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
    return device_tri.freeze(tree, device="cpu").cast(torch.float32)


def bary_values(w, r, in_domain):
    """The kernels' value epilogue (``bary2d.cuh``) in torch, on the CPU or
    the card: float32 weights w [B, 3] and vertex responses r [B, 3] to
    values [B], each product and sum rounded on its own and summed as
    ``torch.sum`` over 3 sums on the card, (p0 + p2) + p1, a -0 made +0;
    +0 where not ``in_domain``."""
    p = w * r
    return torch.where(in_domain, (p[:, 0] + p[:, 2]) + p[:, 1] + 0.0, 0.0)


def _less_or_nan(a, ia, b, ib) -> bool:
    """torch.argmin's order: NaN below every number, the lower index on a
    tie (among NaNs too)."""
    if np.isnan(a):
        return ia < ib if np.isnan(b) else True
    if np.isnan(b):
        return False
    return ia < ib if a == b else bool(a < b)


def _argmin3(w) -> int:
    best = 0
    for j in (1, 2):
        if _less_or_nan(w[j], j, w[best], best):
            best = j
    return best


def _weights(row, qx, qy):
    """The kernel's (and device_tri._weights') float32 weights from one
    affine row (A00 A01 A10 A11 ax ay w00 w01), each operation rounded."""
    e0, e1 = qx - row[4], qy - row[5]
    w0 = (row[0] * e0 + row[1] * e1) + row[6]
    w1 = (row[2] * e0 + row[3] * e1) + row[7]
    return [w0, w1, np.float32(1.0) - (w0 + w1)]


def walk2d_plain(q, start, nbrs, affine, max_steps: int, tol: float = TOL):
    """The kernel's walk, query by query, on the CPU: float32 queries q
    [M, 2] from simplexes ``start`` [M] of a float32 triangulation
    (``nbrs`` [T, 3], ``affine`` [T, 8]).

    Returns (leaf int64 [M], w float32 [M, 3], in_domain bool [M], n int64
    [M]), ``in_domain`` with ``locate_cells``'s every weight > -0.5 and
    ``n`` each query's iteration count, ``max_steps + 1`` where it never
    stopped.  The kernel finds ``start`` itself, as ``cells.hint`` of the
    query's cell, with a NaN coordinate in cell column (row) 0.
    """
    qs = q.detach().cpu().numpy().astype(np.float32, copy=False)
    aff = affine.detach().cpu().numpy().astype(np.float32, copy=False)
    nb = nbrs.detach().cpu().numpy()
    starts = torch.as_tensor(start).cpu().numpy()
    with np.errstate(invalid="ignore", over="ignore"):  # NaN and infinite queries
        out = [_walk_one(qx, qy, int(t), nb, aff, max_steps, np.float32(-tol))
               for (qx, qy), t in zip(qs, starts)]
    leaf, w, in_domain, n = zip(*out) if out else ((), (), (), ())
    return (torch.tensor(leaf, dtype=torch.int64),
            torch.from_numpy(np.array(w, np.float32).reshape(-1, 3)),
            torch.tensor(in_domain, dtype=torch.bool), torch.tensor(n, dtype=torch.int64))


def _walk_one(qx, qy, cur, nb, aff, max_steps, ntol):
    """One query's walk: (leaf, weights, in_domain, iterations)."""
    prev, outside, n = -1, False, max_steps + 1
    for s in range(max_steps):
        w = _weights(aff[cur], qx, qy)
        worst = _argmin3(w)
        if s & 1 and sum(bool(x < ntol) for x in w) > 1:
            w2 = list(w)
            w2[worst] = np.float32(np.inf)
            worst = _argmin3(w2)
        inside = all(x >= ntol for x in w)
        nbr = int(nb[cur, worst])
        hit_boundary = nbr < 0 and not inside
        if inside or hit_boundary or nbr == prev:
            outside, n = hit_boundary, s + 1
            break
        prev, cur = cur, nbr
    w = _weights(aff[cur], qx, qy)
    contained = all(x >= ntol for x in w)
    sane = all(x > np.float32(-0.5) for x in w)
    return cur, w, not outside and (contained or n <= max_steps) and sane, n
