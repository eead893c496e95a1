"""sin6x_cos6y: sin(6x) cos(6y), the headline's field (bench.py:84 and :158)."""

import numpy as np


def values(sites):
    """[n] float64 values at ``sites`` [n, 2]."""
    return np.sin(6 * sites[:, 0]) * np.cos(6 * sites[:, 1])
