"""Port's models/interp2d.py vs the JAX package, on the CPU, in float64.

The same numpy grids and queries go through the JAX ``Interp2D`` and the
port's: the derivative grids of the bicubic init, and eval, eval_extrap,
eval_e and all five derivatives, within 1e-12 of JAX (relative to the
largest JAX value where that exceeds 1).  A JAX state carried across
(``convert.interp2d_from_jax``) evaluates to JAX's values too.

A derivative of order (a, b) is the patch's value in cell units divided by
dx^a dy^b, so both packages' rounding is amplified by 1 / (dx^a dy^b): on
a random 23-knot axis with a 0.0036-wide cell, deriv_xx's one-ulp
difference in cell units is 1.7e-11.  Derivatives are compared in cell
units, (got - want) dx^a dy^b, the number the patch computes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import interp2d as ji2

import gsl_scattered_interpolation_torch as gsi
from gsl_scattered_interpolation_torch.models import convert
from gsl_scattered_interpolation_torch.models import interp2d as i2
from gsl_scattered_interpolation_torch.utils import errors

CPU = "cpu"
OPS = ("eval", "eval_extrap", "eval_deriv_x", "eval_deriv_y", "eval_deriv_xx",
       "eval_deriv_xy", "eval_deriv_yy")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores, and eight threads per worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(nx=6, ny=7, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 4, nx))
    y = np.sort(rng.uniform(0, 5, ny))
    z = np.sin(x)[:, None] * np.cos(y)[None, :]
    return x, y, z


def _queries(x, y, n=300, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.uniform([x[0] - 0.3, y[0] - 0.3], [x[-1] + 0.3, y[-1] + 0.3], size=(n, 2))
    gx, gy = np.meshgrid(x, y, indexing="ij")
    return np.concatenate([q[:, 0], gx.ravel()]), np.concatenate([q[:, 1], gy.ravel()])


ORDERS = {"eval_deriv_x": (1, 0), "eval_deriv_y": (0, 1), "eval_deriv_xx": (2, 0),
          "eval_deriv_xy": (1, 1), "eval_deriv_yy": (0, 2)}


def _close(got, want, tol=1e-12, cell=None):
    """Within tol of want's scale; with ``cell`` (the query cells' dx^a
    dy^b), in cell units."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if cell is not None:
        got, want = got * cell, want * cell
    ok = ~np.isnan(want)
    scale = max(1.0, float(np.abs(want[ok]).max()))
    assert np.abs(got[ok] - want[ok]).max() <= tol * scale


def _cell_units(x, y, xq, yq, op):
    a, b = ORDERS.get(op, (0, 0))
    i = np.clip(np.searchsorted(x, xq, side="right") - 1, 0, x.size - 2)
    j = np.clip(np.searchsorted(y, yq, side="right") - 1, 0, y.size - 2)
    return np.diff(x)[i] ** a * np.diff(y)[j] ** b


@pytest.mark.parametrize("kind", ["bilinear", "bicubic"])
@pytest.mark.parametrize("shape", [(6, 7), (4, 4), (23, 9)])
def test_every_operation_matches_jax(kind, shape):
    x, y, z = _grid(*shape, seed=shape[0])
    j = ji2.interp2d(x, y, z, kind)
    p = gsi.interp2d(x, y, z, kind, device=CPU)
    if kind == "bicubic":
        for name in ("zx", "zy", "zxy"):
            _close(getattr(p, name), getattr(j, name))
    xq, yq = _queries(x, y)
    for op in OPS:
        _close(getattr(p, op)(xq, yq), getattr(j, op)(jnp.asarray(xq), jnp.asarray(yq)),
               cell=_cell_units(x, y, xq, yq, op))
    v, s = p.eval_e(xq, yq)
    jv, js = j.eval_e(jnp.asarray(xq), jnp.asarray(yq))
    _close(v, jv)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_nodal_derivs_one_batched_solve():
    # Each column's derivative equals a 1D natural cspline's, the last node
    # from the end derivative of the last segment.
    from gsl_scattered_interpolation_tpu.models import interp1d as ji1

    x, _, z = _grid(9, 5, seed=3)
    got = i2._cspline_nodal_deriv(torch.tensor(x), torch.tensor(z)).numpy()
    for j in range(z.shape[1]):
        s = ji1.interp(x, z[:, j], "cspline")
        _close(got[:, j], s.eval_deriv(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["bilinear", "bicubic"])
def test_jax_state_carried_across(kind):
    x, y, z = _grid(8, 6, seed=7)
    j = ji2.interp2d(x, y, z, kind)
    fields = {"kind": kind, "x": x, "y": y, "z": z}
    if kind == "bicubic":
        fields.update({k: np.asarray(getattr(j, k)) for k in ("zx", "zy", "zxy")})
    p = convert.interp2d_from_jax(fields, device=CPU)
    xq, yq = _queries(x, y, seed=8)
    for op in OPS:
        _close(getattr(p, op)(xq, yq), getattr(j, op)(jnp.asarray(xq), jnp.asarray(yq)),
               cell=_cell_units(x, y, xq, yq, op))


def test_strict_and_api():
    x, y, z = _grid()
    p = i2.interp2d(x, y, z, "bicubic", device=CPU)
    with pytest.raises(errors.DomainError):
        p.eval(np.array([x[-1] + 1.0]), np.array([y[0]]), strict=True)
    assert np.isfinite(p.eval(np.array([x[1]]), np.array([y[1]]), strict=True).numpy()).all()
    with pytest.raises(errors.InvalidArgumentError):
        i2.interp2d(np.arange(4.0), np.arange(5.0), np.zeros((5, 4)), device=CPU)
    with pytest.raises(errors.InvalidArgumentError):
        i2.interp2d(np.arange(3.0), np.arange(3.0), np.zeros((3, 3)), "bicubic", device=CPU)
    with pytest.raises(errors.InvalidArgumentError):
        i2.interp2d(np.array([0.0, 2.0, 1.0, 3.0]), np.arange(4.0), np.zeros((4, 4)), device=CPU)
    with pytest.raises(errors.InvalidArgumentError):
        i2.interp2d(x, y, z, "biquintic", device=CPU)
    zf = torch.arange(12.0)  # xsize=3, ysize=4
    assert i2.idx(2, 1, 3) == 5
    assert float(i2.zget(zf, 2, 1, 3)) == 5.0
    zf2 = i2.zset(zf, 0, 0, 3, 99.0)
    assert float(zf2[0]) == 99.0 and float(zf[0]) == 0.0
    sp = gsi.spline2d(x, y, z, "bilinear", device=CPU)
    assert isinstance(sp, gsi.Spline2D) and sp.name == "bilinear" and sp.min_size == 2
    assert float(sp.xmin) == x[0] and float(sp.ymax) == y[-1]
