"""Rank jobs for tests/test_torch_parallel.py.

Each spawned rank runs :func:`run`: every sharded function of the port on
the inputs the test made, with the results as numpy arrays.  This module
imports torch, numpy and the port only, so the ranks never import JAX.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from gsl_scattered_interpolation_torch.models import rbf, rbf_compact
from gsl_scattered_interpolation_torch.parallel import (
    cholesky,
    dryrun,
    mesh as pmesh,
    ring,
    sharding,
)

INTERP_METHODS = ("pallas", "auto", "walk", "cells")


def _np(t):
    return t.cpu().numpy()


def run(world, inputs):
    """{name: result} of this rank; the inputs are replicated on every
    rank, as the JAX package replicates its global arrays."""
    out = {"rank": dist.get_rank(), "jax_imported": "jax" in sys.modules}

    dp_mesh = pmesh.make_mesh(dp=world, tp=1, device="cpu")
    mixed = pmesh.make_mesh(tp=2, device="cpu")
    tp_mesh = pmesh.make_mesh(dp=1, tp=world, device="cpu")
    sp_mesh = pmesh.make_ring_mesh("cpu")
    out["mesh_shapes"] = [tuple(m.shape) for m in (dp_mesh, mixed, tp_mesh, sp_mesh)]
    try:
        pmesh.make_mesh(dp=3, tp=2, device="cpu")
        out["mesh_error"] = None
    except ValueError as e:
        out["mesh_error"] = str(e)

    # dp-sharded evaluation, each route; the whole output and, on the
    # (dp, tp) mesh, this rank's block.
    tri, resp, q, cells = (inputs["interp"][k] for k in ("tri", "resp", "q", "cells"))
    out["interp"] = {}
    for method in INTERP_METHODS:
        c = cells if method == "cells" else None
        block = sharding.interp_sharded(tri, resp, q, dp_mesh, method=method, cells=c)
        out["interp"][method] = _np(sharding.gather_rows(block, dp_mesh))
    out["interp_mixed"] = (mixed.get_local_rank("dp"),
                           _np(sharding.interp_sharded(tri, resp, q, mixed)))

    # tp-sharded RBF matvec and CG fit.
    mv = inputs["matvec"]
    rows = sharding._block(mv["xs"].shape[0], tp_mesh, "tp", "test")
    group = tp_mesh.get_group("tp")
    local = sharding.rbf_matvec_sharded(
        mv["xs"][rows], mv["v"][rows], rbf.KERNELS["wendland_c2"].phi, 6.0, 0.5, group)
    out["matvec"] = _np(sharding.all_gather_rows(local, group))
    given = sharding.rbf_matvec_sharded(
        mv["xs"][rows], mv["v"][rows], rbf.KERNELS["wendland_c2"].phi, 6.0, 0.5, group,
        xs_all=mv["xs"])
    out["matvec_sites_given_equal"] = bool(torch.equal(given, local))
    cg = inputs["cg"]
    stats = {}
    out["cg"] = _np(sharding.rbf_fit_cg_sharded(
        cg["sites"], cg["values"], tp_mesh, kernel="wendland_c2", epsilon=6.0,
        tol=1e-12, maxiter=2000, stats=stats))
    out["cg_stats"] = stats

    # The sp ring: one matvec and a fit on each grid.
    phi = rbf.KERNELS["wendland_c2"].phi
    out["ring"] = {}
    for name, g in inputs["ring"].items():
        grid = ring.pad_grid_rows(g["grid"], world)
        rows = sharding._block(grid.xs_pad.shape[0], sp_mesh, "sp", "test")
        v_pad = rbf_compact.pack_values(grid, g["v"])
        group = sp_mesh.get_group("sp")
        got = ring.matvec_ring(grid.xs_pad[rows], v_pad[rows], phi, g["eps"], 0.5, group)
        given = ring.matvec_ring(grid.xs_pad[rows], v_pad[rows], phi, g["eps"], 0.5, group,
                                 xs_ext=ring._extend_sites(grid.xs_pad[rows], group))
        rec = {"matvec": _np(sharding.all_gather_rows(got, group)),
               "halo_given_equal": bool(torch.equal(given, got))}
        if "fit" in g:
            y_pad = rbf_compact.pack_values(grid, g["fit"])
            lam_pad, res, its = ring.fit_cg_ring(
                grid, y_pad, sp_mesh, epsilon=g["eps"], tol=1e-13, maxiter=5000)
            rec.update(lam_pad=_np(lam_pad), residual=res, iterations=its)
        out["ring"][name] = rec

    # tp-sharded Cholesky, from the whole matrix and from this rank's rows.
    ch = inputs["cholesky"]
    A = ch["A"]
    L_local = cholesky.cholesky_sharded(A, tp_mesh, block=ch["block"])
    rows = sharding._block(A.shape[0], tp_mesh, "tp", "test")
    L_rows = cholesky.cholesky_sharded(A[rows], tp_mesh, block=ch["block"])
    out["cholesky"] = {
        "L": _np(sharding.all_gather_rows(L_local, tp_mesh.get_group("tp"))),
        "same_from_rows": bool(torch.equal(L_local, L_rows)),
        "x": _np(cholesky.cholesky_solve_sharded(L_local, ch["rhs"], tp_mesh)),
    }

    out["dryrun"] = dryrun.dryrun_multichip(world, "cpu")
    return out
