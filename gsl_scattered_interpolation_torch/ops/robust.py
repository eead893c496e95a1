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


def _stack(pairs):
    """One pair of stacked tensors from a list of pairs."""
    return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])


def _take(pair, idx):
    return pair[0][idx], pair[1][idx]


def _det3_ds(ax, ay, az, bx, by, bz, cx, cy, cz, sc):
    """Double-single 3x3 determinant of rows (a, b, c); args are pairs.

    by*cz - bz*cy, bx*cz - bz*cx, bx*cy - by*cx, then
    (ax*m1 - ay*m2) + az*m3, with the six products, the three minors and
    the three terms each evaluated stacked (one launch per operation)."""
    p = _p_mul(
        _stack([by, bz, bx, bz, bx, by]), _stack([cz, cy, cz, cx, cy, cx]), sc
    )
    m = _p_sub(_take(p, slice(0, 6, 2)), _take(p, slice(1, 6, 2)))
    t = _p_mul(_stack([ax, ay, az]), m, sc)
    return _p_add(_p_sub(_take(t, 0), _take(t, 1)), _take(t, 2))


def _rows_3d(v, w):
    """The exact differences v - w of stacked points [k, ..., 3], as three
    column pairs [k, ...]."""
    hi, lo = _two_sum(v, -w)
    return [(hi[..., j], lo[..., j]) for j in range(3)]


def orient3d_ds(a, b, c, d):
    """Compensated signed 6x volume of the tetrahedron (a, b, c, d); inputs
    [..., 3].  Positive iff d sees (a, b, c) counter-clockwise."""
    sc = _split_const(a.dtype)
    r = _rows_3d(torch.stack(torch.broadcast_tensors(a, b, c)), d)
    rows = [_take(r[j], i) for i in range(3) for j in range(3)]
    return _det3_ds(*rows, sc)[0]


# Minor k of the 4 rows (v_i - e) drops row k; minor 4 is the orientation
# determinant of the rows (a - d, b - d, c - d), held as rows 4..6.
_MINOR_ROWS = ((1, 0, 0, 0, 4), (2, 2, 1, 1, 5), (3, 3, 3, 2, 6))


def insphere_orient3d_ds(a, b, c, d, e):
    """Compensated 3D in-circumsphere and orientation determinants,
    ``(insphere_ds(a, b, c, d, e), orient3d_ds(a, b, c, d))``, evaluated
    together: the seven difference rows, then the five 3x3 minors, each
    stacked on a leading axis.  Each element sees the JAX package's
    operations in its order."""
    sc = _split_const(a.dtype)
    a, b, c, d, e = torch.broadcast_tensors(a, b, c, d, e)
    r = _rows_3d(torch.stack([a, b, c, d, a, b, c]), torch.stack([e, e, e, e, d, d, d]))
    rows = [_take(r[j], list(idx)) for idx in _MINOR_ROWS for j in range(3)]
    m = _det3_ds(*rows, sc)  # [5, ...]
    rel = _stack([_take(r[j], slice(0, 4)) for j in range(3)])  # [3, 4, ...]
    sq = _p_mul(rel, rel, sc)
    lift = _p_add(_p_add(_take(sq, 0), _take(sq, 1)), _take(sq, 2))
    # la*det(b,c,d), lb*det(a,c,d), lc*det(a,b,d), ld*det(a,b,c)
    t = _p_mul(lift, _take(m, slice(0, 4)), sc)
    t1, t2, t3, t4 = (_take(t, k) for k in range(4))
    # The renormalized head alone carries the sign (h == 0 => value == 0).
    return _p_add(_p_sub(t2, t1), _p_sub(t4, t3))[0], m[0][4]


def insphere_ds(a, b, c, d, e):
    """Compensated 3D in-circumsphere determinant; inputs [..., 3].

    det[(v_i - e | |v_i - e|^2)] over v in (a, b, c, d), expanded along the
    lift column with a global -1.  Multiply by
    ``sign(orient3d_ds(a, b, c, d))``: the product is positive iff e lies
    strictly inside the circumsphere.
    """
    return insphere_orient3d_ds(a, b, c, d, e)[0]


def _detn_ds(rows, sc):
    """Double-single determinant of an n x n matrix of pairs (a list of n
    rows of n (hi, lo) pairs), by cofactor expansion along the first row."""
    n = len(rows)
    if n == 1:
        return rows[0][0]
    if n == 2:
        return _p_sub(
            _p_mul(rows[0][0], rows[1][1], sc),
            _p_mul(rows[0][1], rows[1][0], sc),
        )
    if n == 3:
        return _det3_ds(*rows[0], *rows[1], *rows[2], sc)
    acc = None
    for j in range(n):
        sub = [[row[k] for k in range(n) if k != j] for row in rows[1:]]
        t = _p_mul(rows[0][j], _detn_ds(sub, sc), sc)
        if j % 2 == 1:
            t = (-t[0], -t[1])
        acc = t if acc is None else _p_add(acc, t)
    return acc


def orientnd_ds(verts):
    """Compensated ``det(verts[1:] - verts[0])`` in any dimension;
    ``verts`` [..., d+1, d]."""
    sc = _split_const(verts.dtype)
    d = verts.shape[-1]
    base = verts[..., 0, :]
    rows = [
        [_p_diff(verts[..., i, j], base[..., j]) for j in range(d)]
        for i in range(1, d + 1)
    ]
    return _detn_ds(rows, sc)[0]


def inspherend_ds(verts, q):
    """Compensated ``(-1)^d det[(verts - q | |verts - q|^2)]`` in any
    dimension; ``verts`` [..., d+1, d], ``q`` [..., d].  Multiply by
    ``sign(orientnd_ds(verts))``: positive iff q lies strictly inside the
    circumsphere."""
    sc = _split_const(verts.dtype)
    d = verts.shape[-1]
    rows = []
    for i in range(d + 1):
        rel = [_p_diff(verts[..., i, j], q[..., j]) for j in range(d)]
        lift = _p_mul(rel[0], rel[0], sc)
        for j in range(1, d):
            lift = _p_add(lift, _p_mul(rel[j], rel[j], sc))
        rows.append(rel + [lift])
    h = _detn_ds(rows, sc)[0]
    return h if d % 2 == 0 else -h


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
