"""Partition-of-unity thin-plate splines: the "fast RBF method" at scale.

The counterpart of the JAX package's ``models/rbf_pu.py``.  Global
thin-plate systems lose their answer to cancellation in float32 at scale
(the coefficients grow like h^-2); partition of unity fits many small,
unit-scaled local thin-plate splines and blends them with smooth,
compactly supported weights.

Construction (2D):

* Sites are bucketed into a uniform grid of cells (side H); each CELL owns
  a patch whose fit set is its 3x3 cell neighborhood (rolled, with the
  wrapped offsets masked).
* The neighborhoods are compacted to ``W2`` slots, their populated ones
  first (the largest population, rounded up to 8): the same systems minus
  decoupled identity rows.
* Every patch solves its local thin-plate saddle system in coordinates
  scaled to the patch radius, all patches of a chunk in one batched LU
  solve (``torch.linalg.solve``, partial pivoting) on the fit's device.
* The blend weight of patch p is wendland_c2(|x - c_p| / H); every site is
  interpolated by every patch active there, so the blend
  s(x) = sum_p w_p s_p(x) / sum_p w_p interpolates all data and is C1.
* Evaluation touches the 3x3 patches around the query's cell.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from . import rbf, rbf_compact
from ..utils import config, errors

log = logging.getLogger(__name__)

_POISON = 1e7


class PuTps(NamedTuple):
    """Fitted partition-of-unity TPS model (padded SoA)."""

    xs9: torch.Tensor     # [Gy, Gx, W, 2] per-patch fit sites (poison pads)
    lam: torch.Tensor     # [Gy, Gx, W] local TPS coefficients
    poly: torch.Tensor    # [Gy, Gx, 3] local affine tails (in patch coords)
    origin: torch.Tensor  # [2] grid origin (standardized coords)
    cell: float           # cell side H
    rad: float            # patch coordinate scale (= 1.5 H)
    shift: torch.Tensor   # [2] raw->standardized shift
    scale: torch.Tensor   # [2] raw->standardized scale

    @property
    def shape(self):
        return tuple(self.xs9.shape[:2])


def _phi_tps(r):
    safe = torch.where(r > 0, r, 1.0)
    return torch.where(r > 0, r * r * torch.log(safe), 0.0)


def _neighborhood9(xs_pad, fill=_POISON):
    """[Gy, Gx, 9*cap, d] — each cell's 3x3 block, via rolls (no gathers).

    A roll WRAPS at the grid border: an edge patch's "neighbor" block
    would hold real sites from the opposite side of the domain, which wreck
    the patch system's conditioning.  Wrapped slots are overwritten with
    ``fill`` (poison for coordinates, 0 for values).
    """
    Gy, Gx = xs_pad.shape[:2]
    parts = []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            rolled = torch.roll(xs_pad, (-di, -dj), dims=(0, 1))
            ok = rbf_compact._inside(Gy, Gx, di, dj, xs_pad.device)
            shape = ok.shape + (1,) * (xs_pad.ndim - 2)
            parts.append(torch.where(ok.reshape(shape), rolled, fill))
    return torch.cat(parts, dim=2)


def _solve_patches(xb, vb, cc, rad, smooth):
    """Local TPS fits of one chunk: xb [c, W, 2], vb [c, W], centres cc
    [c, 2] -> (lam [c, W], poly [c, 3])."""
    c, Ws = xb.shape[:2]
    u = (xb - cc[:, None, :]) / rad
    pad_row = torch.any(torch.abs(u) > 100.0, dim=-1)  # poison slots
    u = torch.where(pad_row[..., None], 0.0, u)
    diff = u[:, :, None, :] - u[:, None, :, :]
    A = _phi_tps(torch.sqrt(torch.sum(diff * diff, dim=-1)))
    keep = ~pad_row
    A = torch.where(keep[:, :, None] & keep[:, None, :], A, 0.0)
    eye = torch.eye(Ws, dtype=A.dtype, device=A.device)
    A = A + torch.where(pad_row[:, :, None], eye, 0.0)
    A = A + smooth * eye
    P = torch.cat([A.new_ones((c, Ws, 1)), u], dim=-1)
    P = torch.where(keep[..., None], P, 0.0)
    top = torch.cat([A, P], dim=2)
    # tiny negative regularization keeps degenerate patches (e.g. <3
    # non-collinear sites at the hull edge) solvable
    reg = -1e-8 * torch.eye(3, dtype=A.dtype, device=A.device).expand(c, 3, 3)
    bot = torch.cat([P.transpose(1, 2), reg], dim=2)
    K = torch.cat([top, bot], dim=1)
    rhs = torch.cat([torch.where(keep, vb, 0.0), A.new_zeros((c, 3))], dim=1)
    sol = torch.linalg.solve(K, rhs[..., None])[..., 0]
    return sol[:, :Ws] * keep, sol[:, Ws:]


def fit(
    sites,
    values,
    target_per_cell: float = 6.0,
    smooth: float = 0.0,
    chunk: int = 2048,
    dtype=None,
    device="cuda",
    stats: dict | None = None,
):
    """Fit a partition-of-unity TPS to (sites [N,2], values [N]).

    ``dtype`` is float32 on CUDA and float64 on the CPU unless given.
    ``stats``, if a dict, receives the grid shape, ``cap``, ``W`` and
    ``W2``.
    """
    device, dtype = config.device_dtype(device, dtype)
    sites = np.asarray(sites, np.float64)
    values = np.asarray(values, np.float64)
    n, d = sites.shape
    if d != 2:
        raise errors.InvalidArgumentError("PU-TPS is 2D")
    if values.shape != (n,):
        raise errors.InvalidArgumentError("values shape mismatch")

    shift, scale = rbf.standardization(sites)
    xs = scale * (sites - shift)

    # Bucket into cells of side H ~ sqrt(target/N), on the host.
    H = float(np.sqrt(target_per_cell / max(n, 1)))
    grid = rbf_compact.build_cell_grid(xs, rho=H, as_numpy=True)
    H = grid.cell_size
    Gy, Gx = grid.shape
    cap = grid.cap
    log.info("PU-TPS: grid %dx%d, cap %d (avg %.1f/cell)", Gy, Gx, cap,
             n / (Gy * Gx))
    W = 9 * cap
    rad = 1.5 * H
    origin = np.asarray(grid.origin, np.float64)

    # Patch width: W = 9*cap is sized by the WORST single cell times 9; the
    # 9-cell neighborhood populations are far smaller (mean ~9*target), and
    # the patch LU costs O(width^3).  Compact every neighborhood to the
    # largest POPULATED count (the same system minus decoupled identity
    # pad rows).
    counts = (grid.slot_site >= 0).sum(-1)  # [Gy, Gx]
    padded = np.pad(counts, 1)
    conv9 = sum(
        padded[1 + di : Gy + 1 + di, 1 + dj : Gx + 1 + dj]
        for di in (-1, 0, 1)
        for dj in (-1, 0, 1)
    )
    W2 = min(W, max(32, int(-(-int(conv9.max()) // 8) * 8)))
    if stats is not None:
        stats.update(grid=[Gy, Gx], cap=cap, W=W, W2=W2)

    slot = grid.slot_site
    v_pad = np.where(slot >= 0, values[np.clip(slot, 0, n - 1)], 0.0)
    xs_pad = torch.tensor(grid.xs_pad, dtype=dtype, device=device)
    v_pad = torch.tensor(v_pad, dtype=dtype, device=device)
    xs9 = _neighborhood9(xs_pad)                        # [Gy, Gx, W, 2]
    v9 = _neighborhood9(v_pad[..., None], fill=0.0)[..., 0]
    cy = float(origin[0]) + (torch.arange(Gy, dtype=dtype, device=device) + 0.5) * H
    cx = float(origin[1]) + (torch.arange(Gx, dtype=dtype, device=device) + 0.5) * H
    centers = torch.stack(torch.meshgrid(cy, cx, indexing="ij"), -1)
    xs9f = xs9.reshape(-1, W, 2)
    v9f = v9.reshape(-1, W)
    cf = centers.reshape(-1, 2)
    C = xs9f.shape[0]
    if W2 < W:
        # Stable valid-slots-first compaction to [C, W2]; evaluate() is
        # width-agnostic, poison slots carry lam = 0.
        invalid = (xs9f[..., 0] > _POISON / 2).to(torch.int32)
        order = torch.argsort(invalid, dim=1, stable=True)[:, :W2]
        xs9f = torch.take_along_dim(xs9f, order[..., None], 1)
        v9f = torch.take_along_dim(v9f, order, 1)
    Wc = xs9f.shape[1]
    lam, poly = zip(*(
        _solve_patches(xs9f[s : s + chunk], v9f[s : s + chunk],
                       cf[s : s + chunk], rad, smooth)
        for s in range(0, C, chunk)
    ))
    return PuTps(
        xs9=xs9f.reshape(Gy, Gx, Wc, 2),
        lam=torch.cat(lam).reshape(Gy, Gx, Wc),
        poly=torch.cat(poly).reshape(Gy, Gx, 3),
        origin=torch.tensor(origin, dtype=dtype, device=device),
        cell=float(H),
        rad=float(rad),
        shift=torch.tensor(shift, dtype=dtype, device=device),
        scale=torch.tensor(scale, dtype=dtype, device=device),
    )


def evaluate(model: PuTps, q_raw):
    """Blended evaluation at [B, 2] raw queries."""
    dtype = model.xs9.dtype
    q = torch.atleast_2d(
        torch.as_tensor(q_raw, dtype=dtype, device=model.xs9.device)
    )
    qs = model.scale * (q - model.shift)
    Gy, Gx = model.shape
    W = model.xs9.shape[2]
    cell = model.cell
    ij = torch.floor((qs - model.origin) / cell).to(torch.int64)
    iy = torch.clamp(ij[:, 0], 0, Gy - 1)
    ix = torch.clamp(ij[:, 1], 0, Gx - 1)
    xs_flat = model.xs9.reshape(Gy * Gx, W, 2)
    lam_flat = model.lam.reshape(Gy * Gx, W)
    poly_flat = model.poly.reshape(Gy * Gx, 3)
    wend = rbf.KERNELS["wendland_c2"].phi

    num = qs.new_zeros(qs.shape[0])
    den = qs.new_zeros(qs.shape[0])
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            ny = torch.clamp(iy + di, 0, Gy - 1)
            nx = torch.clamp(ix + dj, 0, Gx - 1)
            valid = ((iy + di) == ny) & ((ix + dj) == nx)
            rowsid = ny * Gx + nx
            ctr = torch.stack(
                [
                    model.origin[0] + (ny.to(dtype) + 0.5) * cell,
                    model.origin[1] + (nx.to(dtype) + 0.5) * cell,
                ],
                -1,
            )
            dq = qs - ctr
            wgt = wend(torch.sqrt(torch.sum(dq * dq, dim=-1)), 1.0 / cell) * valid
            xb = xs_flat[rowsid]          # [B, W, 2]
            lb = lam_flat[rowsid]         # [B, W]
            pb = poly_flat[rowsid]        # [B, 3]
            u = (qs[:, None, :] - xb) / model.rad
            # poison slots carry lam = 0; clamp the radius to keep f32 finite
            r = torch.clamp_max(torch.sqrt(torch.sum(u * u, dim=-1)), 1e6)
            uq = dq / model.rad
            s_p = torch.sum(_phi_tps(r) * lb, dim=-1) + (
                pb[:, 0] + pb[:, 1] * uq[:, 0] + pb[:, 2] * uq[:, 1]
            )
            num = num + wgt * s_p
            den = den + wgt
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
