"""Port's models/interp1d.py vs the JAX package, on the CPU, in float64.

The same numpy knots and queries go through the JAX ``Interp1D`` and the
port's, for every kind and operation: values, both derivatives and the
integral within 1e-12 of JAX (relative to the largest JAX value where that
exceeds 1), the ``_e`` status arrays equal, and the same DomainError from
``strict=True``.  A JAX state carried across (``convert.interp1d_from_jax``)
evaluates to JAX's values too.

The polynomial kind integrates the monomial form, whose terms cancel: on
knots spanning 10 the terms reach 10^6 while the integral is O(10), and
JAX and the port both miss the exact rational integral by about 3e-10
(their sums of powers round differently).  So its integral is held within
1e-12 of the terms' magnitude, sum_k |c_k t^(k+1) / (k+1)| at both limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import interp1d as ji1
from gsl_scattered_interpolation_tpu.utils import errors as jerrors

import gsl_scattered_interpolation_torch as gsi
from gsl_scattered_interpolation_torch.models import convert
from gsl_scattered_interpolation_torch.models import interp1d as i1
from gsl_scattered_interpolation_torch.utils import errors

CPU = "cpu"
KINDS = sorted(i1.TYPES)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores, and eight threads per worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=12, seed=1):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 10, n))
    y = np.sin(x) + 0.1 * rng.normal(size=n)
    return x, y


def _kind_data(kind, n=15, seed=2):
    x, y = _data(n, seed)
    if kind.endswith("periodic"):
        y[-1] = y[0]
    return x, y


def _close(got, want, tol=1e-12, scale=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if ok.any():
        if scale is None:
            scale = max(1.0, float(np.abs(want[ok]).max()))
        assert np.abs(got[ok] - want[ok]).max() <= tol * scale


def _integ_scale(p, a, b):
    """The magnitude of the terms the polynomial kind's integral sums."""
    if p.kind != "polynomial":
        return None
    mono = i1._poly_monomial(p.dd, p.x).numpy()
    k = np.arange(mono.size) + 1.0

    def terms(t):
        return np.abs(mono * np.asarray(t, float)[..., None] ** k / k).sum(-1)

    return float(np.max(terms(a) + terms(b)))


def _queries(x):
    # Knots, interior points, both ends and two points outside.
    inner = np.linspace(x[0], x[-1], 97)
    return np.concatenate([x, inner, [x[0] - 0.5, x[-1] + 0.5]])


def test_bsearch_gsl_semantics():
    x = np.array([0.0, 1.0, 2.0, 3.0])
    q = np.array([-5.0, 0.0, 0.5, 1.0, 2.9, 3.0, 99.0])
    got = i1.bsearch(torch.tensor(x), torch.tensor(q))
    np.testing.assert_array_equal(got.numpy(), [0, 0, 0, 1, 2, 2, 2])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ji1.bsearch(jnp.asarray(x), jnp.asarray(q)))
    )
    assert i1.find_interval(torch.tensor(x), torch.tensor(2.5)).shape == ()


@pytest.mark.parametrize("kind", KINDS)
def test_init_and_every_operation_match_jax(kind):
    n = 9 if kind == "polynomial" else 15
    x, y = _kind_data(kind, n)
    j = ji1.interp(x, y, kind)
    p = gsi.interp(x, y, kind, device=CPU)
    assert p.x.dtype == torch.float64 and p.x.device.type == "cpu"
    if kind == "polynomial":
        _close(p.dd, j.dd)
    else:
        _close(p.coef, j.coef)
    q = _queries(x)
    jq = jnp.asarray(q)
    for name in ("eval", "eval_deriv", "eval_deriv2"):
        _close(getattr(p, name)(q), getattr(j, name)(jq))
        v, s = getattr(p, name + "_e")(q)
        jv, js = getattr(j, name + "_e")(jq)
        _close(v, jv)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    a = np.concatenate([np.full(q.size, x[0]), q[::-1]])
    b = np.concatenate([q, q])
    scale = _integ_scale(p, a, b)
    _close(p.eval_integ(a, b), j.eval_integ(jnp.asarray(a), jnp.asarray(b)), scale=scale)
    v, s = p.eval_integ_e(a, b)
    jv, js = j.eval_integ_e(jnp.asarray(a), jnp.asarray(b))
    _close(v, jv, scale=scale)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("kind", KINDS)
def test_jax_state_carried_across(kind):
    x, y = _kind_data(kind, 9 if kind == "polynomial" else 20, seed=5)
    j = ji1.interp(x, y, kind)
    name = "dd" if kind == "polynomial" else "coef"
    p = convert.interp1d_from_jax(
        {"kind": kind, "x": x, "y": y, name: np.asarray(getattr(j, name))}, device=CPU
    )
    q = _queries(x)
    for op in ("eval", "eval_deriv", "eval_deriv2"):
        _close(getattr(p, op)(q), getattr(j, op)(jnp.asarray(q)))
    _close(p.eval_integ(x[0], q), j.eval_integ(jnp.full(q.shape, x[0]), jnp.asarray(q)),
           scale=_integ_scale(p, x[0], q))


@pytest.mark.parametrize("kind", ["linear", "cspline", "akima", "steffen"])
def test_strict_raises_like_jax(kind):
    x, y = _data()
    j = ji1.interp(x, y, kind)
    p = i1.interp(x, y, kind, device=CPU)
    q = np.array([x[0] - 1.0, x[3], x[-1] + 1.0])
    for op in ("eval", "eval_deriv", "eval_deriv2"):
        with pytest.raises(errors.DomainError):
            getattr(p, op)(q, strict=True)
        with pytest.raises(jerrors.DomainError):
            getattr(j, op)(jnp.asarray(q), strict=True)
        _close(getattr(p, op)(q[1:2], strict=True), getattr(j, op)(jnp.asarray(q[1:2])))
    with pytest.raises(errors.DomainError):
        p.eval_integ(np.array([x[2]]), np.array([x[1]]), strict=True)


def test_reversed_limits_edom():
    x, y = _data()
    p = i1.interp(x, y, "cspline", device=CPU)
    vals, status = p.eval_integ_e(np.array([x[2]]), np.array([x[1]]))
    assert np.isnan(vals.numpy()).all()
    assert (status.numpy() == errors.EDOM).all()


def test_scalar_queries():
    x = np.array([0.0, 1.0, 2.0, 3.0])
    p = i1.interp(x, x.copy(), "linear", device=CPU)
    assert p.eval(0.5).shape == ()
    assert float(p.eval_integ(0.0, 3.0)) == pytest.approx(4.5, rel=1e-13)
    assert float(p.eval_integ(0.5, 2.5)) == pytest.approx(3.0, rel=1e-13)


@pytest.mark.parametrize("kind", ["linear", "polynomial", "cspline", "akima", "steffen"])
def test_float32_matches_jax_float32(kind):
    # Both packages in float32 on the same float32 knots: within 4 ulps of
    # the largest value (the tridiagonal solve's rounding, tridiag tests).
    x, y = (a.astype(np.float32) for a in _data(9 if kind == "polynomial" else 20, 3))
    q = np.linspace(x[0], x[-1], 50).astype(np.float32)
    p = i1.interp(x, y, kind, device=CPU, dtype=torch.float32)
    got = p.eval(q)
    assert got.dtype == torch.float32
    want = np.asarray(ji1.interp(jnp.asarray(x), jnp.asarray(y), kind).eval(jnp.asarray(q)))
    assert want.dtype == np.float32
    assert np.abs(got.numpy() - want).max() <= 4 * np.spacing(np.abs(want).max())


def test_api_errors_and_registry():
    with pytest.raises(errors.InvalidArgumentError):
        i1.interp([0.0, 1.0], [0.0, 1.0], "cspline", device=CPU)
    with pytest.raises(errors.InvalidArgumentError):
        i1.interp(np.arange(4.0), np.arange(4.0), "akima", device=CPU)
    with pytest.raises(errors.InvalidArgumentError):
        i1.interp([0.0, 2.0, 1.0], [0.0, 1.0, 2.0], "linear", device=CPU)
    with pytest.raises(errors.InvalidArgumentError):
        i1.interp([0.0, 1.0], [0.0, 1.0], "quintic", device=CPU)
    assert set(i1.TYPES) == set(ji1.TYPES)
    for k, t in i1.TYPES.items():
        assert t.min_size == ji1.TYPES[k].min_size
    x, y = _data()
    sp = gsi.spline(x, y, "akima", device=CPU)
    assert isinstance(sp, gsi.Spline1D) and sp.name == "akima" and sp.min_size == 5
    assert float(sp.xmin) == x[0] and float(sp.xmax) == x[-1]


def test_periodic_wrap_continuity():
    # The reference's discontinuity detector for periodic splines
    # (test_disc.c:103-121), as tests/test_interp1d.py runs it.
    x = np.linspace(0, 2 * np.pi, 9)
    y = np.sin(x)
    y[-1] = y[0]
    eps = 1e-9
    for kind in ("cspline_periodic", "akima_periodic"):
        p = i1.interp(x, y, kind, device=CPU)
        left = p.eval_deriv(x[1:-1] - eps).numpy()
        right = p.eval_deriv(x[1:-1] + eps).numpy()
        assert np.abs(left - right).max() < 1e-5, kind
        d0, dn = p.eval_deriv(np.array([x[0] + eps, x[-1] - eps])).numpy()
        assert abs(d0 - dn) < 1e-5, kind
