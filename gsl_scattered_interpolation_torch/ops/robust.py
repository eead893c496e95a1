"""Compensated (double-single) geometric predicates.

The counterpart of ``gsl_scattered_interpolation_tpu/ops/robust.py``, op for
op.  The parallel Delaunay build decides every split and flip from the SIGN
of orientation and incircle determinants.  In float32 a plain evaluation
gets the sign wrong on quads that touch the huge cage vertices.  Knuth's
two-sum and Dekker's split/two-product carry each product and sum as an
unevaluated (hi, lo) pair with about twice the working precision, so the
signs are reliable down to ~1e-13 relative in float32.

The error-free transforms are exact only if every multiply and add rounds
on its own.  Eager PyTorch does that; ``torch.compile`` or a CUDA build with
multiply-add contraction would not.  The CUDA kernel of ``ops/candmath.py``
repeats these formulas and is built with ``-fmad=false``.
"""

from __future__ import annotations

import torch

# Dekker splitting constant 2^ceil(p/2) + 1: float32 (p = 24) -> 2^12 + 1.
_SPLIT = {torch.float32: 4097.0, torch.float64: 134217729.0}


def _split_const(dtype):
    return _SPLIT[dtype]


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _two_prod(a, b, sc):
    p = a * b
    a1 = a * sc
    ahi = a1 - (a1 - a)
    alo = a - ahi
    b1 = b * sc
    bhi = b1 - (b1 - b)
    blo = b - bhi
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


def _ds_add(xh, xl, yh, yl):
    sh, sl = _two_sum(xh, yh)
    sl = sl + (xl + yl)
    return _two_sum(sh, sl)


def _ds_mul(xh, xl, yh, yl, sc):
    ph, pl = _two_prod(xh, yh, sc)
    pl = pl + (xh * yl + xl * yh)
    return _two_sum(ph, pl)


def orient2d_ds(a, b, c):
    """Compensated signed twice-area of (a, b, c); inputs [..., 2].

    Positive for counter-clockwise; the sign is reliable to about twice
    the working precision.
    """
    sc = _split_const(a.dtype)
    acx, acx_e = _two_sum(a[..., 0], -c[..., 0])
    acy, acy_e = _two_sum(a[..., 1], -c[..., 1])
    bcx, bcx_e = _two_sum(b[..., 0], -c[..., 0])
    bcy, bcy_e = _two_sum(b[..., 1], -c[..., 1])
    t1h, t1l = _ds_mul(acx, acx_e, bcy, bcy_e, sc)
    t2h, t2l = _ds_mul(acy, acy_e, bcx, bcx_e, sc)
    h, _ = _ds_add(t1h, t1l, -t2h, -t2l)
    return h


# -- pair helpers (each value is an unevaluated (hi, lo) sum) --------------


def _p_add(x, y):
    return _ds_add(x[0], x[1], y[0], y[1])


def _p_sub(x, y):
    return _ds_add(x[0], x[1], -y[0], -y[1])


def _p_mul(x, y, sc):
    return _ds_mul(x[0], x[1], y[0], y[1], sc)


def _p_diff(a, b):
    """Exact difference of two working-precision scalars as a pair."""
    return _two_sum(a, -b)


def incircle_ds(a, b, c, d):
    """Compensated 2D incircle determinant; inputs [..., 2].

    Positive iff d is strictly inside the circumcircle of counter-clockwise
    (a, b, c); multiply by ``sign(orient2d_ds(a, b, c))`` for any order.
    """
    sc = _split_const(a.dtype)
    adx = _p_diff(a[..., 0], d[..., 0])
    ady = _p_diff(a[..., 1], d[..., 1])
    bdx = _p_diff(b[..., 0], d[..., 0])
    bdy = _p_diff(b[..., 1], d[..., 1])
    cdx = _p_diff(c[..., 0], d[..., 0])
    cdy = _p_diff(c[..., 1], d[..., 1])

    def sq_sum(x, y):
        return _p_add(_p_mul(x, x, sc), _p_mul(y, y, sc))

    ad2 = sq_sum(adx, ady)
    bd2 = sq_sum(bdx, bdy)
    cd2 = sq_sum(cdx, cdy)
    # adx*(bdy*cd2 - cdy*bd2) - ady*(bdx*cd2 - cdx*bd2)
    #   + ad2*(bdx*cdy - cdx*bdy)
    m1 = _p_sub(_p_mul(bdy, cd2, sc), _p_mul(cdy, bd2, sc))
    m2 = _p_sub(_p_mul(bdx, cd2, sc), _p_mul(cdx, bd2, sc))
    m3 = _p_sub(_p_mul(bdx, cdy, sc), _p_mul(cdx, bdy, sc))
    t1 = _p_mul(adx, m1, sc)
    t2 = _p_mul(ady, m2, sc)
    t3 = _p_mul(ad2, m3, sc)
    h, _ = _p_add(_p_sub(t1, t2), t3)
    return h
