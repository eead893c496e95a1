"""GSL-style test assertion helpers for pytest.

Rebuilds the semantics of the reference micro-harness ``test/gsl_test.h:35-51``
(``gsl_test_rel``, ``gsl_test_abs``, ``gsl_test_factor``, ``gsl_test_int``) as
numpy-aware assertion functions, so golden-value suites read like the
reference's (``interpolation/test.c:141-179`` uses ``gsl_test_abs(...,1e-10)``).
Pass/fail counting and exit status are pytest's job here.  A copy of the
JAX package's module (it imports numpy only), so the port needs nothing of
that package.
"""

from __future__ import annotations

import numpy as np


def test_rel(result, expected, relative_error, desc: str = ""):
    """Assert |result-expected| <= rel*|expected| (gsl_test_rel semantics).

    GSL treats expected==0 as requiring exact zero-or-below-rel absolute
    error, and propagates NaN mismatches as failures.
    """
    result = np.asarray(result, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    both_nan = np.isnan(result) & np.isnan(expected)
    with np.errstate(invalid="ignore"):
        denom = np.where(expected == 0, 1.0, np.abs(expected))
        err = np.abs(result - expected) / denom
    ok = both_nan | (err <= relative_error)
    assert np.all(ok), (
        f"{desc}: rel error {np.nanmax(np.where(ok, 0.0, err)):.3e} "
        f"> {relative_error:.1e} (worst at {np.unravel_index(np.argmax(np.where(ok, 0.0, err)), err.shape) if err.shape else ()})"
    )


def test_abs(result, expected, absolute_error, desc: str = ""):
    """Assert |result-expected| <= abs tolerance (gsl_test_abs semantics)."""
    result = np.asarray(result, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    both_nan = np.isnan(result) & np.isnan(expected)
    err = np.abs(result - expected)
    ok = both_nan | (err <= absolute_error)
    assert np.all(ok), (
        f"{desc}: abs error {np.nanmax(np.where(ok, 0.0, err)):.3e} "
        f"> {absolute_error:.1e}"
    )


def test_factor(result, expected, factor, desc: str = ""):
    """Assert expected/factor <= result <= expected*factor (gsl_test_factor)."""
    result = np.asarray(result, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    lo = np.minimum(expected / factor, expected * factor)
    hi = np.maximum(expected / factor, expected * factor)
    ok = (result >= lo) & (result <= hi)
    assert np.all(ok), f"{desc}: {result} not within factor {factor} of {expected}"


def test_int(result, expected, desc: str = ""):
    """Assert integer equality (gsl_test_int semantics)."""
    assert np.all(np.asarray(result) == np.asarray(expected)), (
        f"{desc}: {result} != {expected}"
    )
