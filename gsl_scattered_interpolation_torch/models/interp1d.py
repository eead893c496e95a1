"""The gsl_interp 1D family in PyTorch, batched.

The counterpart of ``gsl_scattered_interpolation_tpu/models/interp1d.py``:
the strategy-object API of GSL (``gsl_interp_type``, gsl_interp.h:50-71)
and its seven 1D kernels with the same numerics:

  linear               (linear.c)
  polynomial           (poly.c, Newton divided differences)
  cspline              (cspline.c:94-137, natural)
  cspline_periodic     (cspline.c:146-221, cyclic system)
  akima                (akima.c:95-151, non-periodic ghost slopes)
  akima_periodic       (akima.c:158-180, wrapped ghost slopes)
  steffen              (steffen.c:109-179, monotonicity-preserving)

Each kernel's init gives per-interval coefficients ``[n-1, 4]`` (value, d1,
d2, d3 in the local offset), so one evaluation path serves five kernels.
The spline systems are solved by ``ops/tridiag.py``, on the card by its
Hopper kernel.  Evaluation takes arrays of queries: the interval comes from
``torch.searchsorted`` with ``gsl_interp_bsearch``'s clamping
(gsl_interp.h:157-194); GSL's ``gsl_interp_accel`` cache and its hit/miss
counters have no counterpart (a batch needs no cache).

Out-of-range queries give NaN; the ``_e`` variants also return a status
array (EDOM), as ``gsl_interp_eval_e`` does (interp.c:131-137), and
``strict=True`` raises DomainError.  The polynomial kernel's derivatives
are exact Horner derivatives of the Newton form (JAX: ``jax.grad`` of it).

Entry points take ``device=`` (default "cuda") and ``dtype=`` (float32 on
CUDA, float64 on the CPU).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops import tridiag
from ..utils import errors
from ..utils.config import device_dtype

# ---------------------------------------------------------------------------
# Interval search (gsl_interp_bsearch / gsl_interp_accel_find parity)
# ---------------------------------------------------------------------------


def bsearch(x, xq):
    """Index i with x[i] <= xq < x[i+1], clamped to [0, n-2].

    gsl_interp_bsearch's boundary behaviour (gsl_interp.h:157-194): below
    the range 0, above it (and at xq == x[n-1]) n-2.
    """
    i = torch.searchsorted(x, xq.reshape(-1).contiguous(), right=True) - 1
    return torch.clamp(i, 0, x.shape[0] - 2).reshape(xq.shape)


find_interval = bsearch  # the accelerator's entry point


# ---------------------------------------------------------------------------
# Unified cubic-segment machinery
# ---------------------------------------------------------------------------


def _seg_eval(coef, dx):
    a0, a1, a2, a3 = coef.unbind(-1)
    return a0 + dx * (a1 + dx * (a2 + dx * a3))


def _seg_deriv(coef, dx):
    _, a1, a2, a3 = coef.unbind(-1)
    return a1 + dx * (2.0 * a2 + 3.0 * a3 * dx)


def _seg_deriv2(coef, dx):
    a2, a3 = coef[..., 2], coef[..., 3]
    return 2.0 * a2 + 6.0 * a3 * dx


def _seg_antideriv(coef, dx):
    a0, a1, a2, a3 = coef.unbind(-1)
    return dx * (a0 + dx * (a1 / 2 + dx * (a2 / 3 + dx * (a3 / 4))))


# ---------------------------------------------------------------------------
# Kernel inits -> per-segment cubic coefficients.  y is [n] or [n, m] (m
# curves over the same knots, for interp2d); coefficients are [n-1, 4] or
# [n-1, m, 4].
# ---------------------------------------------------------------------------


def _along(v, y):
    """A knot-axis vector [k] shaped to broadcast against y's rows."""
    return v.reshape(-1, *([1] * (y.dim() - 1)))


def _coef_linear(x, y):
    h = _along(torch.diff(x), y)
    m = torch.diff(y, dim=0) / h
    z = torch.zeros_like(m)
    return torch.stack([y[:-1], m, z, z], dim=-1)


def _coef_from_c(x, y, c):
    """Segment coefficients from the cspline second-derivative array ``c``
    (the b/d formulas of cspline.c coeff_calc, :238-250)."""
    h = _along(torch.diff(x), y)
    dy = torch.diff(y, dim=0)
    b = dy / h - h * (c[1:] + 2.0 * c[:-1]) / 3.0
    d = (c[1:] - c[:-1]) / (3.0 * h)
    return torch.stack([y[:-1], b, c[:-1], d], dim=-1)


def _inv_nonzero(h):
    ok = h != 0
    return torch.where(ok, 1.0 / torch.where(ok, h, 1.0), 0.0)


def _coef_cspline(x, y):
    n = x.shape[0]
    c = torch.zeros_like(y)
    if n > 2:
        h = torch.diff(x)
        dy = torch.diff(y, dim=0)
        g = _along(_inv_nonzero(h), y)
        diag = 2.0 * (h[1:] + h[:-1])
        offdiag = h[1:-1]
        rhs = 3.0 * (dy[1:] * g[1:] - dy[:-1] * g[:-1])
        c[1:-1] = tridiag.solve_symm_tridiag(diag, offdiag, rhs)
    return _coef_from_c(x, y, c)


def _coef_cspline_periodic(x, y):
    n = x.shape[0]
    if n == 2:
        # Degenerate periodic: constant second derivative 0.
        return _coef_from_c(x, y, torch.zeros_like(y))
    h = torch.diff(x)
    dy = torch.diff(y)
    g = _inv_nonzero(h)
    # Cyclic system over c[1..n-1] (cspline.c:179-216): row i couples
    # segments i and i+1, the last row wrapping to segment 0.
    h_next = torch.roll(h, -1)
    dyg_next = torch.roll(dy * g, -1)
    diag = 2.0 * (h + h_next)
    rhs = 3.0 * (dyg_next - dy * g)
    sol = tridiag.solve_symm_cyc_tridiag(diag, h_next, rhs)
    c = torch.cat([sol[-1:], sol])  # c[0] = c[n-1]
    return _coef_from_c(x, y, c)


def _akima_coefs(x, y, m_ext):
    """Vectorized akima_calc (akima.c:86-126): m_ext has 2 ghost slopes on
    each side, so m_ext[i+2] == m_i."""
    n = x.shape[0]
    mim2, mim1, mi = m_ext[: n - 1], m_ext[1:n], m_ext[2 : n + 1]
    mip1, mip2 = m_ext[3 : n + 2], m_ext[4 : n + 3]
    NE = torch.abs(mip1 - mi) + torch.abs(mim1 - mim2)
    h = torch.diff(x)
    NE_next = torch.abs(mip2 - mip1) + torch.abs(mi - mim1)
    alpha = torch.abs(mim1 - mim2) / torch.where(NE == 0, 1.0, NE)
    alpha_n = torch.abs(mi - mim1) / torch.where(NE_next == 0, 1.0, NE_next)
    tL_next = torch.where(
        NE_next == 0, mi, (1.0 - alpha_n) * mi + alpha_n * mip1
    )
    b = (1.0 - alpha) * mim1 + alpha * mi
    cc = (3.0 * mi - 2.0 * b - tL_next) / h
    d = (b + tL_next - 2.0 * mi) / (h * h)
    b = torch.where(NE == 0, mi, b)
    cc = torch.where(NE == 0, 0.0, cc)
    d = torch.where(NE == 0, 0.0, d)
    return torch.stack([y[:-1], b, cc, d], dim=-1)


def _coef_akima(x, y):
    m = torch.diff(y) / torch.diff(x)
    # Non-periodic ghost slopes (akima.c:144-147).
    left = torch.stack([3.0 * m[0] - 2.0 * m[1], 2.0 * m[0] - m[1]])
    right = torch.stack([2.0 * m[-1] - m[-2], 3.0 * m[-1] - 2.0 * m[-2]])
    return _akima_coefs(x, y, torch.cat([left, m, right]))


def _coef_akima_periodic(x, y):
    m = torch.diff(y) / torch.diff(x)
    # Periodic ghost slopes (akima.c:173-176).
    return _akima_coefs(x, y, torch.cat([m[-2:], m, m[:2]]))


def _coef_steffen(x, y):
    h = torch.diff(x)
    s = torch.diff(y) / h
    # Interior y' (steffen.c:135-153, eq. 11 of Steffen 1990).
    him1, hi = h[:-1], h[1:]
    sim1, si = s[:-1], s[1:]
    p = (sim1 * hi + si * him1) / (him1 + hi)
    yp_mid = (torch.sign(sim1) + torch.sign(si)) * torch.minimum(
        torch.abs(sim1), torch.minimum(torch.abs(si), 0.5 * torch.abs(p))
    )
    # "Simplest possibility" boundaries (steffen.c:130, 160-163).
    yp = torch.cat([s[:1], yp_mid, s[-1:]])
    a = (yp[:-1] + yp[1:] - 2.0 * s) / (h * h)
    b = (3.0 * s - 2.0 * yp[:-1] - yp[1:]) / h
    return torch.stack([y[:-1], yp[:-1], b, a], dim=-1)


# Steffen's copysign(1, 0) = +1 in C, while torch.sign(0) = 0; GSL's formula
# multiplies by min(|s|, ...), which is 0 whenever a slope is 0, so the
# difference never reaches the result.


# ---------------------------------------------------------------------------
# Polynomial kernel (Newton divided differences, poly.c)
# ---------------------------------------------------------------------------


def _poly_dd(x, y):
    """Divided-difference coefficients, vectorized over levels."""
    n = x.shape[0]
    d = y
    rows = [y[0]]
    for k in range(1, n):
        d = (d[1:] - d[:-1]) / (x[k:] - x[:-k])
        rows.append(d[0])
    return torch.stack(rows)


def _poly_horner(dd, x, xq, order: int):
    """Value (order 0), first (1) or second (2) derivative of the Newton
    form at xq, by Horner's rule and its exact derivative recurrences."""
    n = dd.shape[0]
    p = torch.full_like(xq, 0.0) + dd[n - 1]
    p1 = torch.zeros_like(xq)
    p2 = torch.zeros_like(xq)
    for k in range(n - 2, -1, -1):
        t = xq - x[k]
        if order >= 2:
            p2 = p2 * t + 2.0 * p1
        if order >= 1:
            p1 = p1 * t + p
        p = p * t + dd[k]
    return (p, p1, p2)[order]


def _poly_monomial(dd, x):
    """Newton form -> monomial coefficients (ascending), for integration.

    GSL's Taylor conversion (poly.c eval_integ path), with the same
    conditioning caveats for large n.
    """
    n = dd.shape[0]
    c = torch.zeros_like(dd)
    c[0] = dd[n - 1]
    for k in range(n - 2, -1, -1):
        shifted = torch.roll(c, 1)
        shifted[0] = 0.0
        c = shifted - x[k] * c
        c[0] = c[0] + dd[k]
    return c


# ---------------------------------------------------------------------------
# Type registry (gsl_interp_type analog, gsl_interp.h:50-61)
# ---------------------------------------------------------------------------


class InterpType(NamedTuple):
    name: str
    min_size: int
    init: Callable | None  # (x, y) -> coefficients; None for polynomial


TYPES = {
    "linear": InterpType("linear", 2, _coef_linear),
    "polynomial": InterpType("polynomial", 3, None),  # special-cased
    "cspline": InterpType("cspline", 3, _coef_cspline),
    "cspline_periodic": InterpType(
        "cspline_periodic", 2, _coef_cspline_periodic
    ),
    "akima": InterpType("akima", 5, _coef_akima),
    "akima_periodic": InterpType("akima_periodic", 5, _coef_akima_periodic),
    "steffen": InterpType("steffen", 3, _coef_steffen),
}


def check_knots(x, name: str = "x") -> None:
    """InvalidArgumentError unless ``x`` is strictly increasing
    (interp.c:79-85)."""
    if not bool(torch.all(torch.diff(x) > 0)):
        raise errors.InvalidArgumentError(
            f"{name} values must be strictly increasing"
        )


class Interp1D:
    """1D interpolant over strictly increasing x (gsl_interp analog).

    Every evaluation method takes an array of queries; out-of-domain
    queries give NaN (the ``*_e`` variants also return EDOM status).
    """

    def __init__(self, x, y, kind: str = "cspline", device="cuda", dtype=None):
        if kind not in TYPES:
            raise errors.InvalidArgumentError(
                f"unknown interpolation type {kind!r}; have {sorted(TYPES)}"
            )
        t = TYPES[kind]
        device, dtype = device_dtype(device, dtype)
        x = torch.as_tensor(x, dtype=dtype, device=device)
        y = torch.as_tensor(y, dtype=dtype, device=device)
        if x.shape[0] < t.min_size:
            raise errors.InvalidArgumentError(
                f"{kind} requires at least {t.min_size} points"
                f" (gsl min_size), got {x.shape[0]}"
            )
        check_knots(x)
        self.kind = kind
        self.type = t
        self.x = x
        self.y = y
        if kind == "polynomial":
            self.dd = _poly_dd(x, y)
        else:
            self.coef = t.init(x, y)

    # -- properties mirroring gsl_interp --------------------------------

    @property
    def name(self) -> str:
        return self.kind

    @property
    def min_size(self) -> int:
        return self.type.min_size

    @property
    def xmin(self):
        return self.x[0]

    @property
    def xmax(self):
        return self.x[-1]

    # -- evaluation ------------------------------------------------------

    def _queries(self, xq):
        return torch.as_tensor(xq, dtype=self.x.dtype, device=self.x.device)

    def _domain_mask(self, xq):
        return (xq >= self.x[0]) & (xq <= self.x[-1])

    def _masked(self, vals, xq, strict):
        ok = self._domain_mask(xq)
        if strict:
            errors.strict_check(
                ok, errors.DomainError, "interpolation point outside range"
            )
        return torch.where(ok, vals, torch.nan)

    def _raw_eval(self, xq, seg_fn):
        i = bsearch(self.x, xq)
        return seg_fn(self.coef[i], xq - self.x[i])

    def _status(self, ok):
        return torch.where(ok, errors.SUCCESS, errors.EDOM)

    def _eval_order(self, xq, order: int, strict: bool):
        xq = self._queries(xq)
        if self.kind == "polynomial":
            vals = _poly_horner(self.dd, self.x, xq, order)
        else:
            vals = self._raw_eval(xq, (_seg_eval, _seg_deriv, _seg_deriv2)[order])
        return self._masked(vals, xq, strict)

    def eval(self, xq, strict: bool = False):
        return self._eval_order(xq, 0, strict)

    def eval_deriv(self, xq, strict: bool = False):
        return self._eval_order(xq, 1, strict)

    def eval_deriv2(self, xq, strict: bool = False):
        return self._eval_order(xq, 2, strict)

    def eval_e(self, xq):
        xq = self._queries(xq)
        return self.eval(xq), self._status(self._domain_mask(xq))

    def eval_deriv_e(self, xq):
        xq = self._queries(xq)
        return self.eval_deriv(xq), self._status(self._domain_mask(xq))

    def eval_deriv2_e(self, xq):
        xq = self._queries(xq)
        return self.eval_deriv2(xq), self._status(self._domain_mask(xq))

    def eval_integ_e(self, a, b):
        a, b = self._queries(a), self._queries(b)
        return self.eval_integ(a, b), self._status(self._integ_mask(a, b))

    def _integ_mask(self, a, b):
        # gsl_interp_eval_integ_e (interp.c): limits must lie in the domain
        # AND satisfy a <= b; a reversed interval is EDOM, not a signed
        # integral.
        return self._domain_mask(a) & self._domain_mask(b) & (a <= b)

    def eval_integ(self, a, b, strict: bool = False):
        """Integral over [a, b] (gsl_interp_eval_integ semantics)."""
        a, b = torch.broadcast_tensors(self._queries(a), self._queries(b))
        if self.kind == "polynomial":
            mono = _poly_monomial(self.dd, self.x)
            k = torch.arange(mono.shape[0], dtype=mono.dtype, device=mono.device) + 1.0

            def antider(t):
                return torch.sum(mono * t[..., None] ** k / k, dim=-1)

            vals = antider(b) - antider(a)
        else:
            h = torch.diff(self.x)
            full = _seg_antideriv(self.coef, h)
            prefix = torch.cat([torch.zeros_like(full[:1]), torch.cumsum(full, 0)])

            def upto(t):
                i = bsearch(self.x, t)
                return prefix[i] + _seg_antideriv(self.coef[i], t - self.x[i])

            vals = upto(b) - upto(a)
        ok = self._integ_mask(a, b)
        if strict:
            errors.strict_check(
                ok, errors.DomainError, "integration limits outside range"
            )
        return torch.where(ok, vals, torch.nan)


class Spline1D(Interp1D):
    """gsl_spline analog: the same API; owns its copies of x and y
    (gsl_spline.h:39-44), as Interp1D already does."""


def interp(x, y, kind="cspline", device="cuda", dtype=None) -> Interp1D:
    return Interp1D(x, y, kind, device=device, dtype=dtype)


def spline(x, y, kind="cspline", device="cuda", dtype=None) -> Spline1D:
    return Spline1D(x, y, kind, device=device, dtype=dtype)
