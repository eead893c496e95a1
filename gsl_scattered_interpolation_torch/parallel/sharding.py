"""Sharded query evaluation and distributed RBF solves.

The counterpart of the JAX package's ``parallel/sharding.py``.  JAX runs
each function once over a mesh and returns a global array; here every rank
of the mesh calls it (SPMD) and gets its own part:

* :func:`interp_sharded`: data-parallel barycentric evaluation.  The
  queries are sharded over ``dp`` and the triangulation (and a cell index)
  replicated; each rank evaluates its row block with
  ``device_tri.interp``, with no communication.  :func:`gather_rows`
  assembles the whole output where a caller wants it.
* :func:`rbf_matvec_sharded` / :func:`rbf_fit_cg_sharded`: the kernel
  matrix row-block-sharded over ``tp``.  Each rank rebuilds its block of
  phi(|x_i - x_j|) against the all-gathered sites and direction and
  contributes its slice of the matvec; the CG scalars are all-reduced, so
  every rank reads the same ones and leaves the loop at the same step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import device_tri, rbf


def _block(n: int, mesh, axis: str, what: str) -> slice:
    """This rank's rows of ``n``, sharded over the mesh's ``axis``."""
    size = mesh[axis].size()
    if n % size:
        raise ValueError(f"{what}: {n} rows do not divide by {axis} = {size}")
    rows = n // size
    c = mesh.get_local_rank(axis)
    return slice(c * rows, (c + 1) * rows)


def all_gather_rows(x, group) -> torch.Tensor:
    """The blocks ``x`` of every rank of ``group``, stacked along rows in
    rank order (every block has the same shape)."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def gather_rows(out, mesh, axis: str = "dp") -> torch.Tensor:
    """The whole output of :func:`interp_sharded` from each rank's block."""
    return all_gather_rows(out, mesh.get_group(axis))


def interp_sharded(tri, response_ext, q, mesh, method: str = "auto", cells=None):
    """This rank's block of ``device_tri.interp(tri, response_ext, q)``,
    the queries sharded over the mesh's ``dp`` axis.

    ``q`` [B, d] is the whole batch, given to every rank; B must divide by
    the ``dp`` size, and the rank at ``dp`` coordinate c evaluates rows
    c·B/dp to (c+1)·B/dp.  Ranks that share c (along ``tp``) compute the
    same block, as JAX replicates it.  With ``method="cells"`` pass a
    :class:`device_tri.CellIndex`; it is replicated like the
    triangulation.
    """
    block = q[_block(q.shape[0], mesh, "dp", "interp_sharded")]
    return device_tri.interp(tri, response_ext, block, method=method, cells=cells)


def rbf_matvec_sharded(xs_local, v_local, phi, epsilon, smooth, group, xs_all=None):
    """This rank's slice of (A + smooth I) v, A row-block-sharded.

    xs_local: [N/ranks, d] this rank's site block; v_local: [N/ranks].
    The sites and ``v`` are all-gathered over ``group``; the block of A is
    rebuilt on the fly (matrix-free).  ``xs_all``, the whole [N, d] sites
    in rank order where the caller has them, spares their gather.
    """
    if xs_all is None:
        xs_all = all_gather_rows(xs_local, group)
    v_all = all_gather_rows(v_local, group)
    K = phi(rbf.pairwise_dist(xs_local, xs_all), epsilon)
    return K @ v_all + smooth * v_local


def rbf_fit_cg_sharded(
    sites_std,
    values,
    mesh,
    kernel: str = "wendland_c2",
    epsilon: float = 6.0,
    smooth: float = 0.0,
    tol: float = 1e-10,
    maxiter: int = 500,
    axis: str = "tp",
    stats: dict | None = None,
):
    """Distributed matrix-free CG fit of an RBF coefficient vector.

    sites_std [N, d] / values [N] (tensors or arrays, the whole problem on
    every rank) with N divisible by the ``axis`` size.  Each rank keeps its
    row block; the sites being whole on every rank, only the search
    direction is all-gathered, and the CG scalars are all-reduced over
    ``axis``.  Returns the whole coefficient vector on
    every rank.  ``stats``, if given, receives ``iterations`` and
    ``residual`` (|r|).
    """
    phi = rbf.KERNELS[kernel].phi
    group = mesh.get_group(axis)
    sites_std = torch.as_tensor(sites_std, device=mesh.device_type)
    values = torch.as_tensor(values, device=mesh.device_type)
    rows = _block(sites_std.shape[0], mesh, axis, "rbf_fit_cg_sharded")
    xs_local, y_local = sites_std[rows], values[rows]

    def matvec(v_local):
        return rbf_matvec_sharded(xs_local, v_local, phi, epsilon, smooth, group,
                                  sites_std)

    def dot(a, b):
        s = torch.dot(a, b)
        dist.all_reduce(s, group=group)
        return s

    x, rs, it = rbf._cg(matvec, dot, y_local, tol, maxiter)
    if stats is not None:
        stats.update(iterations=int(it), residual=float(torch.sqrt(rs)))
    return all_gather_rows(x, group)
