"""Ring-parallel compact RBF: the cell grid's rows sharded, halos exchanged.

The counterpart of the JAX package's ``parallel/ring.py``.  The compactly
supported RBF matvec (``models/rbf_compact.py``) has a ring structure:
shard the cell grid's ROW axis over the ranks, and the 9-cell stencil
needs only each neighbouring rank's one boundary row per matvec.  One
halo exchange of the values per matvec (point-to-point sends; the sites'
halos are exchanged once per fit) replaces the all-gather of the
dense-sharded path (``sharding.rbf_matvec_sharded``): O(Gx·cap) bytes per
rank instead of O(N).  The local product is ``matvec_pad`` over the
rank's rows and their halos.

No stencil offset wraps around the grid.  JAX's version wraps on both
axes (periodic halos between the first and last device, ``jnp.roll``
along x) and says wrapped rows lie outside the support; that holds only
at 3 or more cells per axis.  With 1 or 2 cells on an axis the wrapped
offset lands on a neighbouring cell and counts its sites again.  Here the
first rank has no row above and the last none below, and the x offsets
are masked as ``rbf_compact.matvec_pad`` masks them; at 3 or more cells
per axis the masked terms are exact zeros, so the result is JAX's there.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import rbf, rbf_compact
from .sharding import _block, all_gather_rows


def pad_grid_rows(grid: rbf_compact.CellGrid, n: int) -> rbf_compact.CellGrid:
    """Pad the cell grid's row axis to a multiple of ``n`` (poison rows)."""
    Gy = grid.xs_pad.shape[0]
    pad = (-Gy) % n
    if pad == 0:
        return grid
    xs = grid.xs_pad
    slot = grid.slot_site
    return grid._replace(
        xs_pad=torch.cat(
            [xs, xs.new_full((pad,) + tuple(xs.shape[1:]), rbf_compact._POISON)]
        ),
        slot_site=torch.cat(
            [slot, slot.new_full((pad,) + tuple(slot.shape[1:]), -1)]
        ),
    )


def _halo_exchange(x_loc, group):
    """(row above, row below) of this rank's block: the previous rank's
    last row and the next rank's first row, by one batch of sends and
    receives.  None where the grid ends: above the first rank and below
    the last.  A group of one rank exchanges nothing."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    top = bot = None
    ops = []
    if r > 0:
        peer = dist.get_global_rank(group, r - 1)
        top = torch.empty_like(x_loc[:1])
        ops += [dist.P2POp(dist.isend, x_loc[:1].contiguous(), peer, group),
                dist.P2POp(dist.irecv, top, peer, group)]
    if r < n - 1:
        peer = dist.get_global_rank(group, r + 1)
        bot = torch.empty_like(x_loc[-1:])
        ops += [dist.P2POp(dist.isend, x_loc[-1:].contiguous(), peer, group),
                dist.P2POp(dist.irecv, bot, peer, group)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return top, bot


def _extend(x_loc, group, edge):
    """[R + 2, ...]: this rank's rows between the row above and the row
    below, ``edge`` where the grid ends."""
    top, bot = _halo_exchange(x_loc, group)
    return torch.cat([edge if top is None else top, x_loc,
                      edge if bot is None else bot])


def _extend_sites(xs_loc, group):
    """The sites' extended block; a row past the grid's edge holds poison
    sites, like ``matvec_pad``'s off-grid rows."""
    return _extend(xs_loc, group, xs_loc.new_full(xs_loc[:1].shape, rbf_compact._POISON))


def matvec_ring(xs_loc, v_loc, phi, eps, smooth, group, xs_ext=None):
    """Local rows of (A + smooth I) v with halo exchange.

    xs_loc: [R, Gx, cap, d] this rank's cell rows (padded layout);
    v_loc: [R, Gx, cap].  Returns the local [R, Gx, cap] slice:
    ``matvec_pad`` over the rows and their halos, rows 1..R.  A halo row
    past the grid's edge holds poison sites with zero values, so it adds
    exact zeros.  ``xs_ext``, the sites' extended block
    (``_extend_sites``), spares their exchange where a caller runs many
    matvecs on the same sites.
    """
    if xs_ext is None:
        xs_ext = _extend_sites(xs_loc, group)
    v_ext = _extend(v_loc, group, v_loc.new_zeros(v_loc[:1].shape))
    # matvec_pad reads only the grid's sites.
    halo = rbf_compact.CellGrid(xs_pad=xs_ext, slot_site=None, n_sites=0,
                                cell_size=0.0, origin=None)
    return rbf_compact.matvec_pad(halo, phi, eps, smooth, v_ext)[1:-1]


def fit_cg_ring(
    grid: rbf_compact.CellGrid,
    y_pad,
    mesh,
    kernel: str = "wendland_c2",
    epsilon: float = 8.0,
    smooth: float = 0.0,
    tol: float = 1e-10,
    maxiter: int = 2000,
    axis: str = "sp",
):
    """Distributed CG fit on the row-sharded cell grid.

    ``grid`` and ``y_pad`` are whole on every rank; each rank keeps its
    rows.  The grid's row count must divide by the ``axis`` size
    (:func:`pad_grid_rows`).  Returns (the whole coefficient vector in
    padded layout on every rank, |r|, iterations): those of
    ``rbf_compact._cg_pad(..., blocks=ranks)``, bit for bit.
    """
    phi = rbf.KERNELS[kernel].phi
    group = mesh.get_group(axis)
    rows = _block(grid.xs_pad.shape[0], mesh, axis, "fit_cg_ring")
    xs_loc = grid.xs_pad[rows]
    y_loc = y_pad[rows]
    mask = (grid.slot_site[rows] >= 0).to(y_loc.dtype)

    def dot(a, b):
        # The ranks' sums added in rank order, not in the collective's
        # order: the result is _cg_pad(..., blocks=ranks)'s to the bit.
        parts = all_gather_rows(torch.sum(a * b * mask).reshape(1), group)
        return rbf_compact.sum_in_order(parts)

    xs_ext = _extend_sites(xs_loc, group)

    def mv(v):
        return matvec_ring(xs_loc, v, phi, epsilon, smooth, group, xs_ext) * mask

    x, rs, it = rbf._cg(mv, dot, y_loc, tol, maxiter)
    return all_gather_rows(x, group), float(torch.sqrt(rs)), int(it)
