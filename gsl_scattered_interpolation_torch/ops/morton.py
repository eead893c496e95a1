"""Morton (Z-order) codes: spatial sort keys for locality-aware blocking.

The JAX package's ``ops/morton.py``, copied: host numpy, run once per fit
on integer-quantized standardized coordinates.  The RBF family's
preconditioned solver orders its sites by it, so that the local-Lagrange
anchors spread over the domain.
"""

from __future__ import annotations

import numpy as np


def _part1by1(x: np.ndarray) -> np.ndarray:
    """Spread the low 16 bits of x to even bit positions (2D interleave)."""
    x = x.astype(np.uint32) & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def morton2(ix: np.ndarray, iy: np.ndarray) -> np.ndarray:
    """Interleave two 16-bit integer grids into 32-bit Morton codes."""
    return (_part1by1(ix) << 1) | _part1by1(iy)


def morton_order(coords: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation sorting [N, 2] points along the Z-order curve."""
    coords = np.asarray(coords, np.float64)
    lo = coords.min(0)
    ext = np.maximum(coords.max(0) - lo, 1e-300)
    q = np.minimum(
        ((coords - lo) / ext * ((1 << bits) - 1)).astype(np.uint32),
        (1 << bits) - 1,
    )
    return np.argsort(morton2(q[:, 0], q[:, 1]), kind="stable")
