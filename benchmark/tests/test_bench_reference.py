"""The plain reference against hand-made triangulations and scipy."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference import delaunay_linear as ref

EPS32 = 2.0**-23
CAGE = ref.cage_vertices([0.0, 0.0], [1.0, 1.0], EPS32)


def _ref(sites, values, q, **kw):
    v, ties, unc = ref.interpolate(torch.tensor(sites, dtype=torch.float64),
                                   torch.tensor(values, dtype=torch.float64),
                                   torch.tensor(q, dtype=torch.float64), CAGE, **kw)
    return v.numpy(), ties.numpy(), unc


def test_cage_is_linear_simplex_c():
    # A regular triangle of inradius 1/eps**(1/5) about the origin.
    r = 1.0 / EPS32 ** 0.2
    assert torch.allclose(CAGE[0], torch.tensor([2 * r, 0.0], dtype=torch.float64))
    assert torch.allclose(CAGE[1], torch.tensor([-r, r * math.sqrt(3)], dtype=torch.float64))
    assert torch.allclose(CAGE.mean(0), torch.zeros(2, dtype=torch.float64), atol=1e-9)


def test_hand_made_quadrilateral():
    # Four sites; (0.5, 0.62) is not cocircular with the unit square's
    # corners, so the Delaunay diagonal is fixed: a = (0,0), b = (1,0),
    # c = (0,1), d = (1, 1.1).  d lies outside the circle through a, b, c
    # (centre (0.5, 0.5), radius^2 0.5: |d - c|^2 = 0.25 + 0.36 > 0.5), so
    # the diagonal is b-c and the triangles are (a, b, c) and (b, d, c).
    sites = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.1]]) * 0.4 - 0.2
    values = np.array([1.0, 2.0, 3.0, 5.0])
    q = np.array([[0.2, 0.3], [0.7, 0.6]]) * 0.4 - 0.2
    v, ties, unc = _ref(sites, values, q)
    # (0.2, 0.3) in (a, b, c): weights 0.5, 0.2, 0.3.
    assert v[0] == pytest.approx(0.5 * 1 + 0.2 * 2 + 0.3 * 3, abs=1e-12)
    # (0.7, 0.6) in (b, d, c): solve q = w_b b + w_d d + w_c c.
    B, D, C = np.array([1.0, 0.0]), np.array([1.0, 1.1]), np.array([0.0, 1.0])
    M = np.array([[B[0], D[0], C[0]], [B[1], D[1], C[1]], [1, 1, 1]])
    w = np.linalg.solve(M, [0.7, 0.6, 1.0])
    assert v[1] == pytest.approx(w @ [2.0, 5.0, 3.0], abs=1e-12)
    assert unc == 0 and np.isnan(ties[:, 1:]).all()


def test_cocircular_square_admits_both_diagonals():
    sites = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]) * 0.4 - 0.2
    values = np.array([0.0, 1.0, 1.0, 0.0])
    q = np.array([[0.6, 0.3]]) * 0.4 - 0.2
    v, ties, _ = _ref(sites, values, q, tie_fn=lambda r: ref.tie_height(1e-9, 0.0, r))
    admitted = set(np.round(ties[0][~np.isnan(ties[0])], 12))
    # Diagonal a-d: q in (a, b, d) with weights 0.4, 0.3, 0.3, value 0.3;
    # diagonal b-c: q in (a, b, c) with weights 0.1, 0.6, 0.3, value 0.9.
    assert {0.3, 0.9} <= admitted


def test_agrees_with_scipy_inside_the_hull():
    scipy_interp = pytest.importorskip("scipy.interpolate")
    rng = np.random.default_rng(5)
    sites = rng.uniform(-0.5, 0.5, (400, 2))
    values = np.sin(6 * sites[:, 0]) * np.cos(6 * sites[:, 1])
    q = rng.uniform(-0.3, 0.3, (2000, 2))
    v, _, unc = _ref(sites, values, q)
    want = scipy_interp.LinearNDInterpolator(sites, values)(q)
    assert unc == 0
    assert np.nanmax(np.abs(v - want)) < 1e-12


def test_tf32_rounding():
    # TF32 keeps 10 mantissa bits: half an ulp (2^-11) rounds away from
    # zero, a quarter ulp down, three quarters up.
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-12, 1.0 + 3 * 2.0**-12])
    assert ref._round_tf32(x).tolist() == [1.0 + 2.0**-10, 1.0, 1.0 + 2.0**-10]
