"""One pass over every sharded path at small shapes, on every rank.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:
the tp-sharded CG fit of a Wendland RBF and the sp ring fit on the
row-sharded cell grid, each against its single-process CG, the
tp-sharded Cholesky and its solve, and dp-sharded evaluation of the
weather set over a replicated triangulation, by ``method="auto"`` and by
a replicated cell index, the two agreeing within 1e-8, and the gathered
output bit-equal to the single-process ``interp``.

    python -m gsl_scattered_interpolation_torch.parallel.dryrun --world-size 4 --device cpu

starts the ranks (gloo on the CPU, NCCL on CUDA: one card per rank) and
prints each rank's summary.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models import device_tri, host_tree, rbf, rbf_compact
from ..utils import datasets
from . import cholesky, launch, mesh as pmesh, ring, sharding

# The sharded CG fits against their single-process counterparts: the JAX
# package's test tolerance for its sharded CG.
CG_VS_SINGLE_MAX = 1e-6


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_multichip(world_size: int, device="cuda") -> dict:
    """Every sharded path once on a (dp, tp) mesh and an sp ring over the
    group's ``world_size`` ranks; call it on every rank.  Raises on a
    failed check; returns this rank's summary."""
    tp = 2 if world_size % 2 == 0 else 1
    dp = world_size // tp
    mesh = pmesh.make_mesh(dp=dp, tp=tp, device=device)
    dtype = torch.float64

    # tp-sharded distributed RBF fit (all-gather, all-reduce).
    rng = np.random.default_rng(0)
    n_sites = tp * 32
    rsites = rng.uniform(-0.5, 0.5, size=(n_sites, 2))
    rvals = np.sin(3 * rsites[:, 0]) + rsites[:, 1]
    lam = sharding.rbf_fit_cg_sharded(
        rsites, rvals, mesh, kernel="wendland_c2", epsilon=4.0,
        tol=1e-8, maxiter=100,
    )
    _check(bool(torch.isfinite(lam).all()), "non-finite RBF coefficients")
    lam_one, _ = rbf._cg_matfree(
        torch.tensor(rsites, device=device), torch.tensor(rvals, device=device),
        rbf.KERNELS["wendland_c2"].phi, 4.0, 0.0, 1e-8, 100, n_sites,
    )
    cg_diff = float((lam - lam_one).abs().max())
    _check(cg_diff < CG_VS_SINGLE_MAX, f"CG fit against the single-process CG: {cg_diff}")

    # sp ring: halo-exchange compact-RBF CG over the row-sharded cell grid.
    sp_mesh = pmesh.make_ring_mesh(device)
    csites = rng.uniform(-0.5, 0.5, size=(400, 2))
    cvals = np.sin(4 * csites[:, 0]) + csites[:, 1]
    grid = ring.pad_grid_rows(
        rbf_compact.build_cell_grid(csites, rho=1.0 / 8.0, device=device, dtype=dtype),
        world_size,
    )
    y_pad = rbf_compact.pack_values(grid, torch.tensor(cvals, dtype=dtype, device=device))
    lam_pad, res, its = ring.fit_cg_ring(
        grid, y_pad, sp_mesh, epsilon=8.0, tol=1e-8, maxiter=400
    )
    _check(bool(torch.isfinite(lam_pad).all()) and res < 1e-4, f"ring residual {res}")
    pad_pad, _, its_one = rbf_compact._cg_pad(
        grid, rbf.KERNELS["wendland_c2"].phi, 8.0, 0.0, y_pad, 1e-8, 400,
        blocks=world_size,
    )
    ring_diff = float((lam_pad - pad_pad).abs().max())
    _check(ring_diff < CG_VS_SINGLE_MAX and its == int(its_one),
           f"ring fit against _cg_pad: {ring_diff}, {its} against {int(its_one)} iterations")

    # tp-sharded blocked Cholesky (all-gathered block columns).
    nA = tp * 64
    B = rng.standard_normal((nA, nA))
    A = torch.tensor(B @ B.T + nA * np.eye(nA), device=device)
    L = cholesky.cholesky_sharded(A, mesh, block=32, axis="tp")
    x = cholesky.cholesky_solve_sharded(L, A @ torch.ones(nA, dtype=dtype, device=device), mesh)
    chol_err = float((x - 1.0).abs().max())
    _check(chol_err < 1e-6, f"Cholesky solve error {chol_err}")

    # dp-sharded scattered evaluation over a replicated triangulation, by
    # the auto route and by a replicated cell index.
    sites, temps = datasets.weather()
    tree = host_tree.build(sites, key=0)
    tri = device_tri.freeze(tree, device=device)
    resp = device_tri.reindex_response(tree, temps, device=device)
    q = torch.tensor(
        rng.uniform([-89.5, 41.0], [-86.5, 43.1], size=(dp * 64, 2)), device=device
    )
    out = sharding.interp_sharded(tri, resp, q, mesh)
    _check(bool(torch.isfinite(out).all()), "non-finite interpolated values")
    cells = device_tri.build_cell_index(tri)
    out_c = sharding.interp_sharded(tri, resp, q, mesh, method="cells", cells=cells)
    cdiff = float((out_c - out).abs().max())
    _check(cdiff < 1e-8, f"cells against auto: {cdiff}")
    whole = sharding.gather_rows(out, mesh)
    _check(torch.equal(whole, device_tri.interp(tri, resp, q)),
           "the gathered output differs from the single-process interp")
    return {
        "rank": torch.distributed.get_rank(),
        "mesh": {"dp": dp, "tp": tp, "sp": world_size},
        "rbf_lam_head": lam[:3].tolist(),
        "cg_vs_single": cg_diff,
        "ring_residual": res,
        "ring_iterations": its,
        "ring_vs_single": ring_diff,
        "cholesky_solve_err": chol_err,
        "interp_head": whole[:3].tolist(),
        "cells_vs_auto": cdiff,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    for rec in launch.spawn(
        dryrun_multichip, args.world_size, args.device, args.world_size, args.device
    ):
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
