"""Machine-precision constants, parameterized by dtype.

The counterpart of ``gsl_machine.h:17-21`` (``GSL_DBL_EPSILON``,
``GSL_SQRT_DBL_EPSILON``, ``GSL_ROOT5_DBL_EPSILON``), all three of which set
tolerances in the scattered engine (cage scale-up ``linear_simplex.c:251``,
circumsphere tie-break ``linear_simplex.c:536``).  Every constant is a
function of dtype, numpy or torch, so the same code runs in float32 on the
GPU and in float64 for GSL-parity validation.
"""

from __future__ import annotations

import numpy as np
import torch


def eps(dtype) -> float:
    """Machine epsilon for a numpy or torch dtype (GSL_DBL_EPSILON analog)."""
    if isinstance(dtype, torch.dtype):
        return float(torch.finfo(dtype).eps)
    return float(np.finfo(np.dtype(dtype)).eps)


def sqrt_eps(dtype) -> float:
    """sqrt(machine epsilon) (GSL_SQRT_DBL_EPSILON analog)."""
    return float(np.sqrt(eps(dtype)))


def root5_eps(dtype) -> float:
    """eps**(1/5) (GSL_ROOT5_DBL_EPSILON analog).

    Sizes the caging simplex: the reference scales the regular-simplex cage
    by ``1/(GSL_ROOT5_DBL_EPSILON * r)`` (linear_simplex.c:251) so its
    insphere dwarfs the data range.
    """
    return float(eps(dtype) ** 0.2)


# Canonical double values, for tests asserting GSL parity.
DBL_EPSILON = eps(np.float64)            # 2.220446049250313e-16
SQRT_DBL_EPSILON = sqrt_eps(np.float64)  # 1.4901161193847656e-08
ROOT5_DBL_EPSILON = root5_eps(np.float64)
