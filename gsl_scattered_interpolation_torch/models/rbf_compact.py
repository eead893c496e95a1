"""Compactly supported ("fast") RBF at scale: cell-list Wendland fitting.

The counterpart of the JAX package's ``models/rbf_compact.py``:

* **Cell-list structure** (built once per fit, on the host): sites are
  bucketed into a uniform grid whose cell size is at least the support
  radius ``rho = 1/eps``, sorted by cell and padded to a fixed per-cell
  capacity, an SoA layout ``[n_cells_y, n_cells_x, cap, d]``.  Pad slots
  hold far-away poison coordinates, so ``phi = 0`` kills them.
* **9-stencil matvec**: a site only interacts with its own and the 8
  adjacent cells.  For each of the 9 offsets the neighbor block is a roll
  of the padded array, and the contribution is one batched
  ``[C, cap, cap] x [C, cap]`` contraction; the offsets are streamed, never
  stacked.  An offset whose rolled cell wraps across the grid's edge is
  masked out (see :func:`matvec_pad`).
* **Block-Jacobi preconditioned CG** on the (strictly PD) compact kernel,
  with optional mixed-precision refinement against host float64
  residuals.
* **Evaluation** buckets queries into the same grid and sums the 9
  neighboring cells' contributions per query.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from . import rbf
from ..utils import config, errors, machine

log = logging.getLogger(__name__)

# Pad-slot coordinate: far outside any standardized data range so every
# distance leaves the compact support.  Must stay f32-SAFE under squaring.
_POISON = 1e8
# _host_matvec_f64 forms the dense kernel up to this many sites.
HOST_DENSE_MAX = 32768


class CellGrid(NamedTuple):
    """Padded cell-list layout of standardized sites (tensors, or numpy
    arrays from ``build_cell_grid(..., as_numpy=True)``)."""

    xs_pad: torch.Tensor     # [Gy, Gx, cap, d] site coords (poison in pads)
    slot_site: torch.Tensor  # [Gy, Gx, cap] original site row or -1 (pads)
    n_sites: int
    cell_size: float         # >= support radius
    origin: torch.Tensor     # [d] grid origin in standardized coords

    @property
    def shape(self):
        return tuple(self.xs_pad.shape[:2])

    @property
    def cap(self) -> int:
        return self.xs_pad.shape[-2]


def build_cell_grid(
    xs_std: np.ndarray, rho: float, as_numpy: bool = False, device="cuda",
    dtype=torch.float64,
) -> CellGrid:
    """Bucket standardized sites into a cell grid with cell size >= rho.

    Host numpy, once per fit.  Capacity = max cell occupancy (no silent
    truncation is possible by construction).  Any d: the grid has one axis
    per coordinate.  The arrays go to ``device`` (coordinates in ``dtype``)
    unless ``as_numpy`` keeps them on the host in float64.
    """
    xs_std = np.asarray(xs_std, np.float64)
    n, d = xs_std.shape
    lo = xs_std.min(0)
    hi = xs_std.max(0)
    ext = np.maximum(hi - lo, 1e-300)
    G = np.maximum(np.floor(ext / rho).astype(int), 1)
    cell = ext / G  # >= rho per axis
    ij = np.minimum((xs_std - lo) / cell, G - 1).astype(np.int64)
    ij = np.maximum(ij, 0)
    n_cells = int(np.prod(G))
    flat = np.ravel_multi_index(tuple(ij.T), tuple(G))
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=n_cells)
    cap = int(counts.max())
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot_site = np.full((n_cells, cap), -1, np.int32)
    within = np.arange(n) - starts[flat[order]]
    slot_site[flat[order], within] = order.astype(np.int32)
    xs_pad = np.full((n_cells, cap, d), _POISON, np.float64)
    xs_pad[flat[order], within] = xs_std[order]
    xs_pad = xs_pad.reshape(*G, cap, d)
    slot_site = slot_site.reshape(*G, cap)
    if not as_numpy:
        xs_pad = torch.tensor(xs_pad, dtype=dtype, device=device)
        slot_site = torch.tensor(slot_site, device=device)
        lo = torch.tensor(lo, dtype=dtype, device=device)
    return CellGrid(
        xs_pad=xs_pad,
        slot_site=slot_site,
        n_sites=n,
        cell_size=float(cell.max()),
        origin=lo,
    )


def pack_values(grid: CellGrid, values) -> torch.Tensor:
    """Site-ordered vector -> padded [Gy, Gx, cap] layout (pads = 0)."""
    v = torch.as_tensor(values, device=grid.slot_site.device)
    ok = grid.slot_site >= 0
    return torch.where(ok, v[torch.where(ok, grid.slot_site, 0).long()], 0.0)


def unpack_values(grid: CellGrid, v_pad) -> torch.Tensor:
    """Padded layout -> site-ordered vector."""
    n = grid.n_sites
    out = v_pad.new_zeros(n + 1)  # row n takes the pads' writes
    tgt = torch.where(grid.slot_site >= 0, grid.slot_site, n).reshape(-1)
    out[tgt.long()] = v_pad.reshape(-1)
    return out[:n]


def _stencil_offsets():
    return [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]


def _inside(Gy: int, Gx: int, di: int, dj: int, device):
    """[Gy, Gx] bool: the cell (iy + di, ix + dj) lies on the grid, so a
    roll by (-di, -dj) brings it to (iy, ix) without wrapping."""
    ok = torch.zeros((Gy, Gx), dtype=torch.bool, device=device)
    ok[max(0, -di) : Gy - max(0, di), max(0, -dj) : Gx - max(0, dj)] = True
    return ok


def _sq_dist(a, b):
    """Sum over the last axis of (a - b)^2, one coordinate at a time."""
    d2 = None
    for k in range(a.shape[-1]):
        t = a[..., k] - b[..., k]
        d2 = t * t if d2 is None else d2 + t * t
    return d2


def matvec_pad(grid: CellGrid, phi, eps, smooth, v_pad):
    """(A + smooth I) v in padded layout: dense 9-stencil contraction.

    For each neighbor offset, rolls the padded site/value blocks into
    alignment and contracts ``phi(dist)`` against the neighbor values,
    batched [C, cap, cap] x [C, cap] products.  Pad entries die through
    phi (distance > support).  Wrapped offsets are masked: the JAX package
    counts on wrapped pairs lying outside the support, which holds only at
    3 or more cells per axis; with 1 or 2, ``roll(-1)`` and ``roll(+1)``
    land on the same cell and count its sites again.  At 3 or more cells
    the masked terms are exact zeros, so the result is JAX's there.
    """
    xs = grid.xs_pad
    Gy, Gx = xs.shape[:2]
    out = smooth * v_pad
    for di, dj in _stencil_offsets():
        if (Gy == 1 and di) or (Gx == 1 and dj):
            continue  # every cell of this offset wraps
        nx = torch.roll(xs, (-di, -dj), dims=(0, 1))
        nv = torch.roll(v_pad, (-di, -dj), dims=(0, 1))
        if di or dj:
            nv = nv * _inside(Gy, Gx, di, dj, xs.device)[..., None]
        # [Gy, Gx, cap_i, cap_j] pair distances per cell pair
        K = phi(torch.sqrt(_sq_dist(xs[:, :, :, None, :], nx[:, :, None, :, :])), eps)
        out = out + torch.einsum("yxij,yxj->yxi", K, nv)
    return out


def sum_in_order(parts):
    """parts[0] + parts[1] + ..., added left to right."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _cg_pad(grid, phi, eps, smooth, y_pad, tol, maxiter, blocks=1):
    """CG on the padded layout; scalars reduce over real slots only:
    (x, r.r, iterations).  With ``blocks`` > 1 each dot product is the
    sum, in order, of its sums over ``blocks`` equal row blocks: the
    sharded ring's arithmetic over as many ranks."""
    mask = (grid.slot_site >= 0).to(y_pad.dtype)

    def dot(a, b):
        if blocks == 1:
            return torch.sum(a * b * mask)
        return sum_in_order([torch.sum(t) for t in (a * b * mask).chunk(blocks)])

    def mv(v):
        return matvec_pad(grid, phi, eps, smooth, v) * mask

    return rbf._cg(mv, dot, y_pad, tol, maxiter)


def _block_jacobi_inv(grid: CellGrid, phi, eps, smooth):
    """Per-cell kernel-block inverses, [Gy, Gx, cap, cap].

    The within-cell restriction of A is itself a Wendland Gram matrix
    (SPD); pad slots get exact identity rows and columns.  A ridge
    ``delta`` caps the block condition at ~1/delta: an ill-conditioned
    block inverse stalls the PCG it is meant to accelerate, and the
    preconditioner only shapes search directions.  The JAX package inverts
    by pivot-free Gauss-Jordan (its TPU's batched LU ran as bf16); the port
    inverts the same ridged SPD blocks by batched Cholesky.
    """
    xs = grid.xs_pad
    r = torch.sqrt(_sq_dist(xs[:, :, :, None, :], xs[:, :, None, :, :]))
    cap = xs.shape[2]
    eye = torch.eye(cap, dtype=xs.dtype, device=xs.device)
    keep = grid.slot_site >= 0
    delta = 100.0 * float(np.sqrt(machine.eps(xs.dtype)))
    B = phi(r, eps) + (smooth + delta) * eye
    B = torch.where(keep[..., :, None] & keep[..., None, :], B, eye)
    return torch.cholesky_inverse(torch.linalg.cholesky(B))


def _pcg_pad(grid, phi, eps, smooth, y_pad, tol, maxiter):
    """Block-Jacobi preconditioned CG on the padded layout:
    (x, r.r, iterations).

    The per-cell block inverse captures the strongest coupling and roughly
    halves the iterations per digit.  The preconditioner runs in full
    precision.  Stopping is on the TRUE residual |r|^2 <= tol^2 |b|^2, as
    in :func:`_cg_pad`.
    """
    mask = (grid.slot_site >= 0).to(y_pad.dtype)
    Binv = _block_jacobi_inv(grid, phi, eps, smooth)

    def dot(a, b):
        return torch.sum(a * b * mask)

    def mv(v):
        return matvec_pad(grid, phi, eps, smooth, v) * mask

    def prec(r):
        return torch.einsum("yxij,yxj->yxi", Binv, r) * mask

    b2 = dot(y_pad, y_pad)
    target = tol * tol * b2

    def cond(state):
        *_, rr, _rz, it = state
        return (rr > target) & (it < maxiter)

    def body(state):
        x, r, p, rr, rz, it = state
        Ap = mv(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        return x, r, p, dot(r, r), rz_new, it + 1

    z0 = prec(y_pad)
    it0 = torch.zeros((), dtype=torch.int32, device=y_pad.device)
    x, _, _, rr, _, it = rbf.while_loop(
        cond, body,
        (torch.zeros_like(y_pad), y_pad, z0, b2, dot(y_pad, z0), it0),
    )
    return x, rr, it


def _phi64(r, eps):
    t = eps * r
    return np.maximum(1.0 - t, 0.0) ** 4 * (4.0 * t + 1.0)


def _host_matvec_f64(xs_std, eps, smooth, lam):
    """Host f64 ``(A + smooth I) @ lam`` for the Wendland-C2 system.

    The residual engine of iterative refinement: kernel entries AND the
    accumulation both run in numpy f64.  Dense pairwise for moderate N;
    cell-list 9-stencil (chunked over cell rows, wrapped offsets masked as
    in :func:`matvec_pad`) beyond.
    """
    xs_std = np.asarray(xs_std, np.float64)
    lam = np.asarray(lam, np.float64)
    n = xs_std.shape[0]
    if n <= HOST_DENSE_MAX:
        out = np.empty(n)
        for i in range(0, n, 256):  # row blocks keep the temporaries in cache
            diff = xs_std[i : i + 256, None, :] - xs_std[None, :, :]
            out[i : i + 256] = _phi64(np.sqrt((diff**2).sum(-1)), eps) @ lam
        return out + smooth * lam
    grid = build_cell_grid(xs_std, 1.0 / eps, as_numpy=True)
    ok = grid.slot_site >= 0
    lam_pad = np.zeros(grid.slot_site.shape)
    lam_pad[ok] = lam[grid.slot_site[ok]]
    xs = grid.xs_pad  # f64 with poison pads (1e16 squared: f64-safe)
    Gy, Gx, cap, _ = xs.shape
    out = smooth * lam_pad
    rows_per = max(1, 50_000_000 // max(Gx * cap * cap, 1))
    for di, dj in _stencil_offsets():
        inside = _inside(Gy, Gx, di, dj, "cpu").numpy()
        nx = np.roll(xs, (-di, -dj), axis=(0, 1))
        nv = np.roll(lam_pad, (-di, -dj), axis=(0, 1)) * inside[..., None]
        for y0 in range(0, Gy, rows_per):
            sl = slice(y0, min(y0 + rows_per, Gy))
            diff = xs[sl][:, :, :, None, :] - nx[sl][:, :, None, :, :]
            K = _phi64(np.sqrt((diff**2).sum(-1)), eps)
            out[sl] += np.einsum("yxij,yxj->yxi", K, nv[sl])
    res = np.zeros(n)
    res[grid.slot_site[ok]] = out[ok]
    return res


class CompactRbf:
    """Wendland-C2 interpolant built on the cell list (strictly PD, d<=3).

    Args:
      sites: [N, 2] raw coordinates.
      values: [N].
      epsilon: inverse support radius in standardized coords.  Default
        picks the support so each site sees ~40 others (pi rho^2 N = 40).
      smooth: ridge on the diagonal (0 interpolates exactly).
      tol / maxiter: PCG stopping controls.
      dtype: float32 on CUDA and float64 on the CPU unless given.
      device: where the fit runs and the model lives.
    """

    def __init__(
        self,
        sites,
        values,
        epsilon: float | None = None,
        smooth: float = 0.0,
        tol: float = 1e-8,
        maxiter: int = 1000,
        standardize: bool = True,
        dtype=None,
        device="cuda",
    ):
        device, dtype = config.device_dtype(device, dtype)
        sites = np.asarray(sites, np.float64)
        values = np.asarray(values, np.float64)
        n, d = sites.shape
        if values.shape != (n,):
            raise errors.InvalidArgumentError("values shape mismatch")
        self.shift, self.scale = rbf.standardization(sites, standardize)
        xs_std = self.scale * (sites - self.shift)
        if epsilon is None:
            target_neighbors = 40.0
            rho = float(np.sqrt(target_neighbors / (np.pi * n)))
            epsilon = 1.0 / rho
        self.epsilon = float(epsilon)
        self.smooth = float(smooth)
        self.kernel = rbf.KERNELS["wendland_c2"]
        self.tol = float(tol)
        self.maxiter = int(maxiter)

        self.grid = build_cell_grid(
            xs_std, 1.0 / self.epsilon, device=device, dtype=dtype
        )
        log.info(
            "CompactRbf: grid %s cap %d (avg occupancy %.1f), eps=%.4g",
            self.grid.shape, self.grid.cap,
            float(n) / (self.grid.shape[0] * self.grid.shape[1]), self.epsilon,
        )
        self.values = torch.tensor(values, dtype=dtype, device=device)
        lam_pad, rs, it = self._solve(pack_values(self.grid, self.values))
        self.lam_pad = lam_pad
        self.cg_iters = int(it)
        self.cg_residual = float(torch.sqrt(rs))
        # kept for iterative refinement (host f64 residuals)
        self._xs_std = xs_std
        self._values64 = values
        self.lam64 = None
        self.refine_history: list[float] = []

    def _solve(self, y_pad):
        return _pcg_pad(
            self.grid, self.kernel.phi, self.epsilon, self.smooth, y_pad,
            tol=self.tol, maxiter=self.maxiter,
        )

    def refine(self, iters: int = 2) -> "CompactRbf":
        """Mixed-precision iterative refinement of the fit weights.

        The residual ``r = y - A lam`` is computed on the HOST in f64
        (kernel entries must exceed f32 accuracy or refinement stalls at
        kappa*eps_f32); each correction re-runs the fit's PCG with ``r`` as
        the right-hand side, and the accumulator lives in host f64.

        Records max|r|_inf BEFORE each pass and after the last in
        ``self.refine_history``; leaves f64 weights in ``self.lam64`` and
        refreshes ``lam_pad`` (so ``eval``/``lam`` use refined weights).
        """
        dtype = self.grid.xs_pad.dtype
        dev = self.grid.xs_pad.device
        lam64 = self.lam.cpu().numpy().astype(np.float64)
        hist = []
        for _ in range(iters):
            r = self._values64 - _host_matvec_f64(
                self._xs_std, self.epsilon, self.smooth, lam64
            )
            hist.append(float(np.max(np.abs(r))))
            r_pad = pack_values(self.grid, torch.tensor(r, dtype=dtype, device=dev))
            d_pad, _, _ = self._solve(r_pad)
            lam64 = lam64 + unpack_values(self.grid, d_pad).cpu().numpy()
        hist.append(float(np.max(np.abs(self._values64 - _host_matvec_f64(
            self._xs_std, self.epsilon, self.smooth, lam64)))))
        self.refine_history = hist
        self.lam64 = lam64
        self.lam_pad = pack_values(
            self.grid, torch.tensor(lam64, dtype=dtype, device=dev)
        )
        return self

    @property
    def lam(self) -> torch.Tensor:
        """Coefficients in original site order."""
        return unpack_values(self.grid, self.lam_pad)

    def eval(self, q):
        """Interpolant at [B, 2] raw queries: 9-cell neighbor sums."""
        xs = self.grid.xs_pad
        q = torch.atleast_2d(torch.as_tensor(q, dtype=xs.dtype, device=xs.device))
        scale = torch.as_tensor(self.scale, dtype=xs.dtype, device=xs.device)
        shift = torch.as_tensor(self.shift, dtype=xs.dtype, device=xs.device)
        return _eval_cells(
            self.grid, self.kernel.phi, self.epsilon, self.lam_pad,
            scale * (q - shift),
        )

    def residual(self):
        """Max |s(x_i) - y_i| over the sites (fit diagnostic)."""
        pred_pad = matvec_pad(
            self.grid, self.kernel.phi, self.epsilon, 0.0, self.lam_pad
        )
        pred = unpack_values(self.grid, pred_pad)
        return torch.max(torch.abs(pred + self.smooth * self.lam - self.values))


def _eval_cells(grid: CellGrid, phi, eps, lam_pad, qs):
    """Sum phi(|q - x_j|) lam_j over the 9 cells around each query."""
    Gy, Gx, cap, d = grid.xs_pad.shape
    ij = torch.floor(
        (qs - grid.origin.to(qs.dtype)) / grid.cell_size
    ).to(torch.int64)
    iy = torch.clamp(ij[:, 0], 0, Gy - 1)
    ix = torch.clamp(ij[:, 1], 0, Gx - 1)
    out = qs.new_zeros(qs.shape[0])
    xs_flat = grid.xs_pad.reshape(Gy * Gx, cap, d)
    lam_flat = lam_pad.reshape(Gy * Gx, cap)
    for di, dj in _stencil_offsets():
        ny = torch.clamp(iy + di, 0, Gy - 1)
        nx = torch.clamp(ix + dj, 0, Gx - 1)
        # Suppress double counting when clipping collapses offsets.
        valid = ((iy + di) == ny) & ((ix + dj) == nx)
        rows = ny * Gx + nx
        xb = xs_flat[rows]        # [B, cap, d] row gather
        lb = lam_flat[rows]       # [B, cap]
        r = torch.sqrt(_sq_dist(qs[:, None, :], xb))
        out = out + torch.where(valid, torch.sum(phi(r, eps) * lb, dim=-1), 0.0)
    return out
