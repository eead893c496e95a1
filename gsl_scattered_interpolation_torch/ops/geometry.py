"""Geometry for scattered-data interpolation (``linear_simplex.c``).

Coordinates are standardized as ``scale * (x - shift)`` exactly as the
reference does (``linear_simplex.c:574-582, 627-633``).  Tensor functions
broadcast over leading axes; the cage construction is host numpy, a tiny
init-time computation.  The JAX package's ``take_rows`` (a flat-gather
workaround for the TPU compiler) is plain indexing here.
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
