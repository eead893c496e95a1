"""Distributed blocked Cholesky with the matrix's rows sharded over ``tp``.

The counterpart of the JAX package's ``parallel/cholesky.py``: a
right-looking blocked factorization, the communication-optimal 1-D version
of ScaLAPACK's pdpotrf.  Each step all-gathers one [n, b] block column,
factors its diagonal block and solves the panel (replicated, O(n b^2)),
and every rank applies the rank-b trailing update to its own rows.
O(n^3 / D) operations and O(n b) words of communication per step.  It
serves the strictly positive definite systems (Wendland kernel matrices,
kriging normal systems).
"""

from __future__ import annotations

import torch

from .sharding import _block, all_gather_rows


def cholesky_sharded(A, mesh, block: int = 256, axis: str = "tp"):
    """This rank's rows of the lower Cholesky factor of PD ``A``.

    Args:
      A: the whole [n, n] symmetric positive definite matrix, or this
        rank's [n/D, n] rows (D the ``axis`` size); only the lower
        triangle is read.  n must divide by D and by ``block``.
      mesh: a device mesh with the ``axis`` name.
      block: panel width b.

    Returns this rank's [n/D, n] rows of L (lower triangular).
    """
    n = A.shape[1]
    D = mesh[axis].size()
    if n % block:
        raise ValueError(f"n={n} must divide by block={block}")
    if n % D:
        raise ValueError(f"n={n} must divide by mesh axis size {D}")
    rows = _block(n, mesh, axis, "cholesky_sharded")
    if A.shape[0] == n:
        A = A[rows]
    elif A.shape[0] != n // D:
        raise ValueError(f"A has {A.shape[0]} rows: want {n} or {n // D}")
    group = mesh.get_group(axis)
    a_local = A.clone()
    for c0 in range(0, n, block):
        c1 = c0 + block
        col = all_gather_rows(a_local[:, c0:c1], group)  # [n, b]
        lkk = torch.linalg.cholesky(col[c0:c1])
        # L[k:, k] = A[k:, k] L_kk^{-T}; zero above the diagonal block,
        # L_kk inside it.
        panel = torch.linalg.solve_triangular(lkk, col.T, upper=False).T
        panel[:c0] = 0.0
        panel[c0:c1] = lkk
        mine = panel[rows]
        a_local[:, c0:c1] = mine
        # Trailing update of the local rows: A[i, c1:] -= L[i, k] L[c1:, k]^T.
        a_local[:, c1:] -= mine @ panel[c1:].T
    # Zero the strict upper triangle of the local rows.
    r = torch.arange(rows.start, rows.stop, device=a_local.device)[:, None]
    c = torch.arange(n, device=a_local.device)[None, :]
    return torch.where(c <= r, a_local, 0.0)


def cholesky_solve_sharded(L_local, b, mesh, axis: str = "tp"):
    """Solve A x = b from the sharded factor (forward and back
    substitution).

    Substitution is sequential across blocks: each rank gathers L once and
    runs the two triangular solves, replicated.  The factorization is the
    O(n^3) part worth distributing; the O(n^2) solves are not.
    """
    L = all_gather_rows(L_local, mesh.get_group(axis))
    rhs = b[:, None] if b.ndim == 1 else b
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)
    return x[:, 0] if b.ndim == 1 else x
