"""The port against the COMPILED reference GSL, as tests/test_gsl_golden.py
holds the JAX package: ``tests/golden/gsl_interp_golden.json`` (generated
by ``tests/golden/golden_gen.c``) at the JAX test's tolerances, every 1D
kernel (eval, deriv, deriv2, integ) and both 2D kernels (eval, deriv_x,
deriv_y), in float64 on the CPU, checked with the port's ``utils.testing``.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import gsl_scattered_interpolation_torch as gsi
from gsl_scattered_interpolation_torch.utils import testing

GOLDEN = json.loads(
    (pathlib.Path(__file__).parent / "golden" / "gsl_interp_golden.json").read_text()
)
KERNELS_1D = ["linear", "polynomial", "cspline", "cspline_periodic", "akima",
              "akima_periodic", "steffen"]
GX = np.array([0.0, 0.7, 1.5, 2.6, 3.1])
GY = np.array([-1.0, -0.2, 0.9, 2.0])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores, and eight threads per worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", KERNELS_1D)

def test_1d_golden(kind):
    x = np.asarray(GOLDEN["x"])
    q = np.asarray(GOLDEN["q"])
    it = gsi.interp(x, np.asarray(GOLDEN["y"]), kind, device="cpu")
    g = GOLDEN[kind]
    testing.test_abs(it.eval(q).numpy(), g["eval"], 1e-10, f"{kind} eval")
    testing.test_abs(it.eval_deriv(q).numpy(), g["deriv"], 1e-9, f"{kind} deriv")
    testing.test_abs(it.eval_deriv2(q).numpy(), g["deriv2"], 1e-8, f"{kind} deriv2")
    # The polynomial integral carries O(1e-7) cancellation noise in GSL and
    # here alike (tests/test_gsl_golden.py).
    tol = 1e-6 if kind == "polynomial" else 1e-10
    testing.test_abs(it.eval_integ(x[0], q).numpy(), g["integ"], tol, f"{kind} integ")


def _z_grid():
    i = np.arange(5)[:, None]
    j = np.arange(4)[None, :]
    return (i * 0.37 - j * 0.81) * (i + 0.5 * j) + 1.0


def _queries():
    nq = 25
    i = np.arange(nq)
    qx = GX[0] + (GX[-1] - GX[0]) * i / (nq - 1.0)
    qy = GY[0] + (GY[-1] - GY[0]) * ((i * 7) % nq) / (nq - 1.0)
    return qx, qy


@pytest.mark.parametrize("kind", ["bilinear", "bicubic"])
def test_2d_golden(kind):
    it = gsi.interp2d(GX, GY, _z_grid(), kind, device="cpu")
    qx, qy = _queries()
    g = GOLDEN[kind]
    testing.test_abs(it.eval(qx, qy).numpy(), g["eval"], 1e-10, kind)
    testing.test_abs(it.eval_deriv_x(qx, qy).numpy(), g["deriv_x"], 1e-9, f"{kind} dx")
    testing.test_abs(it.eval_deriv_y(qx, qy).numpy(), g["deriv_y"], 1e-9, f"{kind} dy")


def test_testing_helpers_match_gsl_semantics():
    testing.test_rel([1.0, 0.0, np.nan], [1.0 + 1e-12, 0.0, np.nan], 1e-11)
    with pytest.raises(AssertionError):
        testing.test_rel([1.1], [1.0], 1e-3)
    testing.test_abs([1.0 + 1e-12], [1.0], 1e-11)
    with pytest.raises(AssertionError):
        testing.test_abs([1.1], [1.0], 1e-3)
    testing.test_factor([2.0, -2.0], [1.0, -1.0], 2.0)
    with pytest.raises(AssertionError):
        testing.test_factor([3.0], [1.0], 2.0)
    testing.test_int([1, 2], [1, 2])
    with pytest.raises(AssertionError):
        testing.test_int([1, 2], [1, 3])
