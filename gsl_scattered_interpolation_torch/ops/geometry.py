"""Geometry for scattered-data interpolation (``linear_simplex.c``).

Coordinates are standardized as ``scale * (x - shift)`` exactly as the
reference does (``linear_simplex.c:574-582, 627-633``).  Tensor functions
broadcast over leading axes; the cage construction is host numpy, a tiny
init-time computation.  The JAX package's ``take_rows`` (a flat-gather
workaround for the TPU compiler) has no counterpart: it is plain indexing
here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import machine

# ---------------------------------------------------------------------------
# Standardization (linear_simplex.c:141-212)
# ---------------------------------------------------------------------------


def standardize(x, shift, scale):
    """Map raw coordinates to standardized space: scale * (x - shift)."""
    return scale * (x - shift)


def unstandardize(x, shift, scale):
    """Inverse of :func:`standardize` (used on cage vertices, :255-260)."""
    return x / scale + shift


def shift_scale_from_bounds(lo, hi):
    """Per-axis shift/scale from min/max (linear_simplex.c:187-198).

    ``shift = (min+max)/2``; ``scale = 1/(max-min)``, or 1.0 where the
    extent is not positive.
    """
    lo = torch.as_tensor(lo)
    hi = torch.as_tensor(hi)
    shift = (lo + hi) / 2.0
    extent = hi - lo
    ok = extent > 0
    scale = torch.where(ok, 1.0 / torch.where(ok, extent, 1.0), 1.0)
    return shift, scale


def isotropic_scale(scale):
    """SIMPLEX_TREE_ISOSCALE: every axis takes the smallest scale component
    (linear_simplex.c:200-212); shift stays per-axis."""
    scale = torch.as_tensor(scale)
    return torch.min(scale).expand(scale.shape)


# ---------------------------------------------------------------------------
# Regular-simplex cage (linear_simplex.c:215-267)
# ---------------------------------------------------------------------------


def regular_simplex(dim: int, dtype=np.float64) -> np.ndarray:
    """Vertices of a regular d-simplex, (d+1, d), unit circumradius.

    The Cartesian construction of linear_simplex.c:215-232: vertex i gets
    ``sqrt(1 - sum_j<i c_j^2)`` on axis i, and all later vertices share
    ``-(1/d + tot2)/chosen`` on that axis.
    """
    s = np.zeros((dim + 1, dim), dtype=np.float64)
    for i in range(dim):
        tot2 = float(np.sum(s[i, :i] ** 2))
        chosen = np.sqrt(1.0 - tot2)
        s[i, i] = chosen
        s[i + 1 :, i] = -(1.0 / dim + tot2) / chosen
    return s.astype(dtype)


def cage_vertices(dim: int, shift, scale, dtype=np.float64) -> np.ndarray:
    """Seed ("cage") vertices in raw coordinates, (d+1, d).

    linear_simplex.c:234-260: the regular simplex is scaled so that its
    insphere radius times ``1/root5(eps)`` dwarfs the standardized data
    range of 0.5, then the inverse shift/scale puts it in raw coordinates.
    """
    s = regular_simplex(dim, np.float64)
    altitude = s[0, 0] - s[1, 0]
    radius = altitude / (dim + 1)
    s = s * (1.0 / (machine.root5_eps(dtype) * radius))
    raw = s / np.asarray(scale, dtype=np.float64) + np.asarray(shift, np.float64)
    return raw.astype(dtype)


# ---------------------------------------------------------------------------
# 2D orientation predicate
# ---------------------------------------------------------------------------


def orient2d(a, b, c):
    """Signed twice-area of triangle (a, b, c); positive counter-clockwise."""
    return (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (
        b[..., 1] - a[..., 1]
    ) * (c[..., 0] - a[..., 0])


# ---------------------------------------------------------------------------
# Batched small linear solves for the circumsphere
# ---------------------------------------------------------------------------


def _solve2(M, rhs):
    """Closed-form 2x2 solve (Cramer), batched; (x [..., 2], ok [...])."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    det = a * d - b * c
    ok = det != 0
    safe = torch.where(ok, det, 1.0)
    x = (rhs[..., 0] * d - b * rhs[..., 1]) / safe
    y = (a * rhs[..., 1] - rhs[..., 0] * c) / safe
    zero = torch.zeros_like(x)
    coords = torch.stack(
        [torch.where(ok, x, zero), torch.where(ok, y, zero)], dim=-1
    )
    return coords, ok


def _solve3(M, rhs):
    """Closed-form 3x3 solve (Cramer), batched; (x [..., 3], ok [...])."""
    m = M
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    ok = det != 0
    safe = torch.where(ok, det, 1.0)
    r0, r1, r2 = rhs[..., 0], rhs[..., 1], rhs[..., 2]
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d_, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    detx = r0 * (e * i - f * h) - b * (r1 * i - f * r2) + c * (r1 * h - e * r2)
    dety = a * (r1 * i - f * r2) - r0 * (d_ * i - f * g) + c * (d_ * r2 - r1 * g)
    detz = a * (e * r2 - r1 * h) - b * (d_ * r2 - r1 * g) + r0 * (d_ * h - e * g)
    coords = torch.stack([detx / safe, dety / safe, detz / safe], dim=-1)
    coords = torch.where(ok[..., None], coords, 0.0)
    return coords, ok


def _solve(M, rhs):
    d = M.shape[-1]
    if d == 2:
        return _solve2(M, rhs)
    if d == 3:
        return _solve3(M, rhs)
    x = torch.linalg.solve_ex(M, rhs[..., None])[0][..., 0]
    ok = torch.all(torch.isfinite(x), dim=-1)
    return torch.where(ok[..., None], x, 0.0), ok


# ---------------------------------------------------------------------------
# Barycentric coordinates (linear_simplex.c:607-651)
# ---------------------------------------------------------------------------


def bary_coords(verts_std, q_std):
    """(coords [..., d], ok [...]) of queries [..., d] in simplexes
    [..., d+1, d], standardized.

    The reference's convention (linear_simplex.c:614-649): the edge matrix
    has columns ``v_i - v_d`` and the right side is ``q - v_d``, so coords
    are the weights of vertices 0..d-1 and vertex d's is ``1 - sum``.  ok
    is False where the simplex is singular (coords 0), which the reference
    treats as "query not inside" (:641-642, 661-663).
    """
    d = verts_std.shape[-1]
    origin = verts_std[..., d, :]
    M = torch.swapaxes(verts_std[..., :d, :] - origin[..., None, :], -1, -2)
    return _solve(M, q_std - origin)


def bary_coords_scaled(verts_raw, q_raw, scale):
    """:func:`bary_coords` from raw coordinates: edge vectors are
    ``scale * (a_raw - b_raw)``, subtracted then scaled, which keeps
    precision when the vertices include the huge cage points."""
    d = verts_raw.shape[-1]
    origin = verts_raw[..., d, :]
    M = torch.swapaxes((verts_raw[..., :d, :] - origin[..., None, :]) * scale, -1, -2)
    return _solve(M, (q_raw - origin) * scale)


def contains(coords, ok=None):
    """Exact containment on barycentric coords (linear_simplex.c:653-676):
    every coordinate and their sum in [0, 1], with no slack."""
    tot = torch.sum(coords, dim=-1)
    inside = (
        torch.all((coords >= 0) & (coords <= 1), dim=-1) & (tot >= 0) & (tot <= 1)
    )
    if ok is not None:
        inside = inside & ok
    return inside


def worst_violation(coords, ok=None):
    """Largest amount by which a coordinate or their sum leaves [0, 1]
    (the fallback metric of ``_find_leaf``, linear_simplex.c:375-390);
    +inf where ``ok`` is False, so a singular simplex is never chosen."""
    tot = torch.sum(coords, dim=-1)
    per = torch.clamp(torch.maximum(-coords, coords - 1.0), min=0.0)
    v = torch.maximum(
        torch.amax(per, dim=-1),
        torch.clamp(torch.maximum(-tot, tot - 1.0), min=0.0),
    )
    if ok is not None:
        v = torch.where(ok, v, torch.inf)
    return v


# ---------------------------------------------------------------------------
# Circumsphere (linear_simplex.c:539-605) and in-sphere test (:495-537)
# ---------------------------------------------------------------------------


def circumsphere(verts_std):
    """(center [..., d], r2 [...], ok [...]) of simplexes [..., d+1, d].

    The Eickemeyer system of linear_simplex.c:552-605: row i is
    ``v_i - v_{i+1}`` with right side ``(|v_i|^2 - |v_{i+1}|^2) / 2``; r2 is
    the squared distance to vertex 0.  ``ok`` False marks a degenerate
    simplex, which callers treat as containing every point (:517-521).
    """
    d = verts_std.shape[-1]
    a = verts_std[..., :d, :] - verts_std[..., 1:, :]
    sq = torch.sum(verts_std * verts_std, dim=-1)
    b = 0.5 * (sq[..., :d] - sq[..., 1:])
    center, ok = _solve(a, b)
    diff = verts_std[..., 0, :] - center
    r2 = torch.sum(diff * diff, dim=-1)
    return center, r2, ok


def in_sphere(center, r2, ok, q_std, dtype=None):
    """Strict in-circumsphere test with the reference's tie-break:
    ``dist2 < r2 (1 - 10 eps)`` (linear_simplex.c:535-536); a degenerate
    simplex (ok False) contains every point (:517-521)."""
    if dtype is None:
        dtype = q_std.dtype
    diff = q_std - center
    dist2 = torch.sum(diff * diff, dim=-1)
    inside = dist2 < r2 * (1.0 - 10.0 * machine.eps(dtype))
    return torch.where(ok, inside, True)
