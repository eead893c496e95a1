"""The gsl_interp2d family (bilinear, bicubic) in PyTorch, batched.

The counterpart of ``gsl_scattered_interpolation_tpu/models/interp2d.py``:
the 2D strategy API (gsl_interp2d.h:37-60) and both kernels:

* bilinear (bilinear.c): cell-local bilinear blend;
* bicubic (bicubic.c:98-177): nodal derivative grids ``zx``, ``zy`` and
  ``zxy`` from 1D natural cubic splines along rows, columns and rows of
  ``zy``, then a 16-term Hermite patch per cell in cell units
  (bicubic.c:178-320).  Each grid's splines are one batched tridiagonal
  solve, m = 2,048 right-hand sides for a 2,048-wide grid: one launch of
  the Hopper kernel of ``ops/tridiag.py`` on the card (the JAX package maps
  one spline per column with ``vmap``).

``z[i, j]`` is the value at ``(x[i], y[j])``, a 2D array in place of GSL's
flat ``z[j*xsize+i]`` (gsl_interp2d.h:72-77); :func:`idx`, :func:`zget` and
:func:`zset` serve the flat layout.  Queries come in arrays and find their
cell by ``torch.searchsorted`` (GSL's two accelerators have no
counterpart).  ``eval`` gives NaN outside the grid (interp2d.c:130-154);
``eval_extrap`` extrapolates with the edge cell (interp2d.c:160-176).

Entry points take ``device=`` (default "cuda") and ``dtype=`` (float32 on
CUDA, float64 on the CPU).
"""

from __future__ import annotations

import torch

from ..utils import errors
from ..utils.config import device_dtype
from . import interp1d


def idx(i, j, xsize):
    """Flat index of grid node (i, j) in GSL layout (interp2d.c IDX2D)."""
    return j * xsize + i


def zget(z_flat, i, j, xsize):
    return z_flat[idx(i, j, xsize)]


def zset(z_flat, i, j, xsize, val):
    """A copy of ``z_flat`` with node (i, j) set to ``val``."""
    out = z_flat.clone()
    out[idx(i, j, xsize)] = val
    return out


def _cspline_nodal_deriv(x, y_cols):
    """d/dx at the nodes of natural csplines over knots ``x`` [n], one per
    column of ``y_cols`` [n, m]: [n, m].  One tridiagonal solve with m
    right-hand sides.

    The derivative at node i is the b coefficient of segment i; at the last
    node, the end derivative of the last segment.
    """
    coef = interp1d._coef_cspline(x, y_cols)  # [n-1, m, 4]
    h_last = x[-1] - x[-2]
    last = coef[-1, :, 1] + h_last * (
        2.0 * coef[-1, :, 2] + 3.0 * coef[-1, :, 3] * h_last
    )
    return torch.cat([coef[:, :, 1], last[None]])


_H = (
    (1.0, 0.0, 0.0, 0.0),
    (0.0, 0.0, 1.0, 0.0),
    (-3.0, 3.0, -2.0, -1.0),
    (2.0, -2.0, 1.0, 1.0),
)


class Interp2D:
    """2D interpolant on a rectilinear grid (gsl_interp2d analog)."""

    MIN_SIZE = {"bilinear": 2, "bicubic": 4}

    def __init__(self, x, y, z, kind: str = "bicubic", device="cuda", dtype=None):
        if kind not in self.MIN_SIZE:
            raise errors.InvalidArgumentError(
                f"unknown 2D interpolation type {kind!r}"
            )
        device, dtype = device_dtype(device, dtype)
        x = torch.as_tensor(x, dtype=dtype, device=device)
        y = torch.as_tensor(y, dtype=dtype, device=device)
        z = torch.as_tensor(z, dtype=dtype, device=device)
        if tuple(z.shape) != (x.shape[0], y.shape[0]):
            raise errors.InvalidArgumentError(
                f"z shape {tuple(z.shape)} != (len(x), len(y))"
                f" = ({x.shape[0]}, {y.shape[0]})"
            )
        ms = self.MIN_SIZE[kind]
        if x.shape[0] < ms or y.shape[0] < ms:
            raise errors.InvalidArgumentError(
                f"{kind} requires a grid of at least {ms}x{ms}"
            )
        interp1d.check_knots(x, "x")
        interp1d.check_knots(y, "y")
        self.kind = kind
        self.x = x
        self.y = y
        self.z = z
        if kind == "bicubic":
            # Nodal derivative grids, bicubic.c:98-177.
            self.zx = _cspline_nodal_deriv(x, z)              # d/dx along rows
            self.zy = _cspline_nodal_deriv(y, z.T.contiguous()).T  # d/dy
            self.zxy = _cspline_nodal_deriv(x, self.zy)       # d/dx of zy

    @property
    def name(self) -> str:
        return self.kind

    @property
    def min_size(self) -> int:
        return self.MIN_SIZE[self.kind]

    @property
    def xmin(self):
        return self.x[0]

    @property
    def xmax(self):
        return self.x[-1]

    @property
    def ymin(self):
        return self.y[0]

    @property
    def ymax(self):
        return self.y[-1]

    # -- cell data -------------------------------------------------------

    def _cell(self, xq, yq):
        xi = interp1d.bsearch(self.x, xq)
        yi = interp1d.bsearch(self.y, yq)
        dx = self.x[xi + 1] - self.x[xi]
        dy = self.y[yi + 1] - self.y[yi]
        t = (xq - self.x[xi]) / dx
        u = (yq - self.y[yi]) / dy
        return xi, yi, dx, dy, t, u

    @staticmethod
    def _corners(grid, xi, yi):
        return (
            grid[xi, yi],
            grid[xi + 1, yi],
            grid[xi, yi + 1],
            grid[xi + 1, yi + 1],
        )

    # -- bicubic patch ---------------------------------------------------

    def _patch_coeffs(self, xi, yi, dx, dy):
        """4x4 monomial coefficients a[..., i, j] of z = sum a_ij t^i u^j.

        From the corner values and cell-scaled derivatives through the
        Hermite matrix H = [[1,0,0,0],[0,0,1,0],[-3,3,-2,-1],[2,-2,1,1]]:
        A = H F H^T, F the corner value/derivative block; algebraically the
        16-term expansion of bicubic.c:244-320.
        """
        f00, f10, f01, f11 = self._corners(self.z, xi, yi)
        fx00, fx10, fx01, fx11 = [
            v * dx for v in self._corners(self.zx, xi, yi)
        ]
        fy00, fy10, fy01, fy11 = [
            v * dy for v in self._corners(self.zy, xi, yi)
        ]
        fxy00, fxy10, fxy01, fxy11 = [
            v * dx * dy for v in self._corners(self.zxy, xi, yi)
        ]
        F = torch.stack(
            [
                torch.stack([f00, f01, fy00, fy01], -1),
                torch.stack([f10, f11, fy10, fy11], -1),
                torch.stack([fx00, fx01, fxy00, fxy01], -1),
                torch.stack([fx10, fx11, fxy10, fxy11], -1),
            ],
            -2,
        )  # [..., 4, 4]
        H = torch.tensor(_H, dtype=F.dtype, device=F.device)
        return torch.einsum("ik,...kl,jl->...ij", H, F, H)

    @staticmethod
    def _powers(t, order: int):
        one = torch.ones_like(t)
        zero = torch.zeros_like(t)
        if order == 0:
            cols = [one, t, t * t, t * t * t]
        elif order == 1:
            cols = [zero, one, 2.0 * t, 3.0 * t * t]
        else:
            cols = [zero, zero, 2.0 * one, 6.0 * t]
        return torch.stack(cols, -1)

    def _bicubic(self, xq, yq, ddx: int, ddy: int):
        xi, yi, dx, dy, t, u = self._cell(xq, yq)
        A = self._patch_coeffs(xi, yi, dx, dy)
        tp = self._powers(t, ddx)
        up = self._powers(u, ddy)
        val = torch.einsum("...ij,...i,...j->...", A, tp, up)
        return val / dx**ddx / dy**ddy

    def _bilinear(self, xq, yq, ddx: int, ddy: int):
        xi, yi, dx, dy, t, u = self._cell(xq, yq)
        z00, z10, z01, z11 = self._corners(self.z, xi, yi)
        if ddx == 0 and ddy == 0:
            return (
                z00 * (1 - t) * (1 - u)
                + z10 * t * (1 - u)
                + z01 * (1 - t) * u
                + z11 * t * u
            )
        if (ddx, ddy) == (1, 0):
            return ((z10 - z00) * (1 - u) + (z11 - z01) * u) / dx
        if (ddx, ddy) == (0, 1):
            return ((z01 - z00) * (1 - t) + (z11 - z10) * t) / dy
        if (ddx, ddy) == (1, 1):
            return (z11 - z10 - z01 + z00) / (dx * dy)
        return torch.zeros_like(t)  # second derivatives of bilinear are 0

    # -- public evaluation ----------------------------------------------

    def _dispatch(self, xq, yq, ddx, ddy, extrap, strict):
        xq = torch.as_tensor(xq, dtype=self.x.dtype, device=self.x.device)
        yq = torch.as_tensor(yq, dtype=self.y.dtype, device=self.y.device)
        xq, yq = torch.broadcast_tensors(xq, yq)
        fn = self._bicubic if self.kind == "bicubic" else self._bilinear
        vals = fn(xq, yq, ddx, ddy)
        if extrap:
            return vals
        ok = (
            (xq >= self.x[0])
            & (xq <= self.x[-1])
            & (yq >= self.y[0])
            & (yq <= self.y[-1])
        )
        if strict:
            errors.strict_check(
                ok, errors.DomainError, "interpolation point outside range"
            )
        return torch.where(ok, vals, torch.nan)

    def eval(self, xq, yq, strict: bool = False):
        return self._dispatch(xq, yq, 0, 0, False, strict)

    def eval_extrap(self, xq, yq):
        return self._dispatch(xq, yq, 0, 0, True, False)

    def eval_e(self, xq, yq):
        vals = self.eval(xq, yq)
        ok = ~torch.isnan(vals)
        return vals, torch.where(ok, errors.SUCCESS, errors.EDOM)

    def eval_deriv_x(self, xq, yq, strict: bool = False):
        return self._dispatch(xq, yq, 1, 0, False, strict)

    def eval_deriv_y(self, xq, yq, strict: bool = False):
        return self._dispatch(xq, yq, 0, 1, False, strict)

    def eval_deriv_xx(self, xq, yq, strict: bool = False):
        return self._dispatch(xq, yq, 2, 0, False, strict)

    def eval_deriv_xy(self, xq, yq, strict: bool = False):
        return self._dispatch(xq, yq, 1, 1, False, strict)

    def eval_deriv_yy(self, xq, yq, strict: bool = False):
        return self._dispatch(xq, yq, 0, 2, False, strict)


class Spline2D(Interp2D):
    """gsl_spline2d analog; owns the grid arrays (gsl_spline2d.h:44-50)."""


def interp2d(x, y, z, kind="bicubic", device="cuda", dtype=None) -> Interp2D:
    return Interp2D(x, y, z, kind, device=device, dtype=dtype)


def spline2d(x, y, z, kind="bicubic", device="cuda", dtype=None) -> Spline2D:
    return Spline2D(x, y, z, kind, device=device, dtype=dtype)
