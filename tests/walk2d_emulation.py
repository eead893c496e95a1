"""The walk kernel's arithmetic, query by query, in numpy on the CPU.

``kernels/csrc/walk2d.cu`` walks each query alone; :func:`walk2d_plain`
repeats that walk step for step, iteration count included, so that
``tests/test_torch_walk2d.py`` can hold the kernel's semantics to the
lockstep loop of ``models/device_tri.py::locate`` without a card, and the
card tests and ``chip_smoke.py --walk2d`` can hold the kernel to it.  The
port itself keeps only the kernel's wrapper (``ops/walk.py``) and the loop.
Imports torch, numpy and the port only.
"""

import numpy as np
import torch

from gsl_scattered_interpolation_torch.ops.walk import TOL


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
