"""Port's ops/tridiag.py vs the JAX package's lax.scan solvers, on the CPU.

XLA on the CPU may contract a multiply and an add into one rounding where
the port rounds twice, so the port is held within 1e-14 of the solution's
scale in float64 and 4 ulps of it in float32.  The partitioned route
multiplies by one reciprocal per row where the sequential one divides, and
eliminates blocks in another order; it is held to the same tolerances.
Each route's plain version is held bit-equal to a scalar loop in its
kernel's order of operations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.ops import tridiag as jtd

from gsl_scattered_interpolation_torch.ops import tridiag
from gsl_scattered_interpolation_torch.utils import errors

DTYPES = {np.float64: torch.float64, np.float32: torch.float32}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores, and eight threads per worker oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(n, seed, cyclic=False):
    rng = np.random.default_rng(seed)
    d = rng.uniform(3.0, 5.0, n)
    e = rng.uniform(-1.0, 1.0, n if cyclic else max(n - 1, 0))
    b = rng.normal(size=n)
    return d, e, b


def _cspline_system(n, seed, cyclic=False):
    """A natural (or periodic) cubic spline's system on knot gaps h in
    [0.5, 1.5]: diag 2 (h_i + h_{i+1}), offdiag h."""
    rng = np.random.default_rng(seed)
    h = rng.uniform(0.5, 1.5, n + 1)
    d = 2.0 * (h[1:] + h[:-1])
    e = h[1:] if cyclic else h[1:-1]
    return d, e, rng.normal(size=n)


SYSTEMS = {"cspline": _cspline_system, "random": _system}
L = tridiag.BLOCK
# L - 1, L and L + 1 rows; 5L + 7 (not a multiple of L); L^2 + 5 (two
# partitioned levels); about 10^5 (three).
PART_SIZES = [L - 1, L, L + 1, 5 * L + 7, L * L + 5, 100_003]


def _close(got, want, dt):
    scale = np.abs(want).max()
    if dt == np.float64:
        assert np.abs(got - want).max() <= 1e-14 * scale
    else:
        assert np.abs(got - want).max() <= 4 * np.spacing(np.float32(scale))


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 40, 300])
def test_symm_matches_jax(n, dt):
    d, e, b = (a.astype(dt) for a in _system(n, n))
    want = np.asarray(jtd.solve_symm_tridiag(jnp.asarray(d), jnp.asarray(e), jnp.asarray(b)))
    got = tridiag.solve_symm_tridiag(*(torch.tensor(a) for a in (d, e, b)))
    assert got.dtype == DTYPES[dt] and got.shape == (n,)
    _close(got.numpy(), want, dt)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1, 2, 3, 9, 40, 300])
def test_cyclic_matches_jax(n, dt):
    d, e, b = (a.astype(dt) for a in _system(n, 100 + n, cyclic=True))
    want = np.asarray(jtd.solve_symm_cyc_tridiag(jnp.asarray(d), jnp.asarray(e), jnp.asarray(b)))
    got = tridiag.solve_symm_cyc_tridiag(*(torch.tensor(a) for a in (d, e, b)))
    _close(got.numpy(), want, dt)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_many_rhs_equal_column_solves(dt):
    # [n, m] is m independent systems that share the matrix: each column
    # equals the solve of that column alone, bit for bit.
    d, e, _ = (a.astype(dt) for a in _system(50, 7))
    B = np.random.default_rng(8).normal(size=(50, 6)).astype(dt)
    got = tridiag.solve_symm_tridiag(torch.tensor(d), torch.tensor(e), torch.tensor(B))
    assert got.shape == (50, 6)
    for j in range(6):
        col = tridiag.solve_symm_tridiag(torch.tensor(d), torch.tensor(e), torch.tensor(B[:, j]))
        np.testing.assert_array_equal(got[:, j].numpy(), col.numpy())
        want = np.asarray(jtd.solve_symm_tridiag(jnp.asarray(d), jnp.asarray(e), jnp.asarray(B[:, j])))
        _close(got[:, j].numpy(), want, dt)


def _scalar_thomas(d, e, b, dt):
    """The kernel's order of operations over numpy scalars of type dt."""
    n = d.shape[0]
    z = dt(0)
    cp, dp = np.zeros(n, dt), np.zeros(n, dt)
    c_prev, d_prev, e_prev = z, z, z
    for i in range(n):
        e_i = e[i] if i < n - 1 else z
        denom = dt(d[i] - dt(e_prev * c_prev))
        c_prev = dt(e_i / denom)
        d_prev = dt(dt(b[i] - dt(e_prev * d_prev)) / denom)
        cp[i], dp[i] = c_prev, d_prev
        e_prev = e_i
    x = np.zeros(n, dt)
    x_next = z
    for i in range(n - 1, -1, -1):
        x_next = dt(dp[i] - dt(cp[i] * x_next))
        x[i] = x_next
    return x


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_plain_version_is_the_kernel_order(dt):
    d, e, b = (a.astype(dt) for a in _system(200, 11))
    B = np.stack([b, b[::-1].copy()], -1)
    got = tridiag.thomas_ref(torch.tensor(d), torch.tensor(e), torch.tensor(B)).numpy()
    for j in range(2):
        np.testing.assert_array_equal(got[:, j], _scalar_thomas(d, e, B[:, j], dt))


def test_cuda_wrapper_refuses_cpu_tensors():
    d, e, b = (torch.tensor(a) for a in _system(5, 1))
    with pytest.raises(errors.InvalidArgumentError):
        tridiag.thomas_cuda(d, e, b[:, None])


@pytest.mark.parametrize("system", sorted(SYSTEMS))
@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", PART_SIZES)
def test_partitioned_matches_jax(n, dt, system):
    d, e, b = (a.astype(dt) for a in SYSTEMS[system](n, 200 + n))
    want = np.asarray(jtd.solve_symm_tridiag(jnp.asarray(d), jnp.asarray(e), jnp.asarray(b)))
    got = tridiag.partitioned_ref(torch.tensor(d), torch.tensor(e), torch.tensor(b)[:, None])
    assert got.dtype == DTYPES[dt] and got.shape == (n, 1)
    _close(got[:, 0].numpy(), want, dt)


PARTITIONED_REF = tridiag.partitioned_ref


@pytest.mark.parametrize("system", sorted(SYSTEMS))
@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", PART_SIZES)
def test_partitioned_cyclic_matches_jax(n, dt, system, monkeypatch):
    # Every size through the partitioned route, y and z in one [n, 2] solve.
    monkeypatch.setattr(tridiag, "PARTITION_MIN_ROWS", 0)
    calls = []
    monkeypatch.setattr(tridiag, "partitioned_ref",
                        lambda *a: calls.append(a[2].shape) or PARTITIONED_REF(*a))
    d, e, b = (a.astype(dt) for a in SYSTEMS[system](n, 300 + n, cyclic=True))
    want = np.asarray(jtd.solve_symm_cyc_tridiag(jnp.asarray(d), jnp.asarray(e), jnp.asarray(b)))
    got = tridiag.solve_symm_cyc_tridiag(*(torch.tensor(a) for a in (d, e, b)))
    assert calls[0] == (n, 2)  # then its reduced systems
    _close(got.numpy(), want, dt)


@pytest.mark.parametrize("n,routed", [(tridiag.PARTITION_MIN_ROWS, "thomas_ref"),
                                      (tridiag.PARTITION_MIN_ROWS + 1, "partitioned_ref")])
def test_route_depends_on_rows(n, routed, monkeypatch):
    calls = []
    for name in ("thomas_ref", "partitioned_ref"):
        fn = getattr(tridiag, name)
        monkeypatch.setattr(tridiag, name,
                            lambda *a, _n=name, _f=fn: calls.append(_n) or _f(*a))
    d, e, b = (torch.tensor(a) for a in _cspline_system(n, 5))
    for rhs in (b, torch.stack([b, -b], 1)):
        calls.clear()
        tridiag.solve_symm_tridiag(d, e, rhs)
        assert calls[0] == routed  # the partitioned route ends in thomas_ref


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_partitioned_columns_are_independent(dt):
    # The block and the depth depend on n alone: each column of [n, m]
    # equals its solve alone, bit for bit, at one, two and three levels.
    for n in (L + 1, L * L + 5, 40_000):
        d, e, _ = (a.astype(dt) for a in _cspline_system(n, n))
        B = np.random.default_rng(n).normal(size=(n, 5)).astype(dt)
        td, te = torch.tensor(d), torch.tensor(e)
        got = tridiag.partitioned_ref(td, te, torch.tensor(B))
        for j in range(5):
            col = tridiag.partitioned_ref(td, te, torch.tensor(B[:, j:j + 1].copy()))
            np.testing.assert_array_equal(got[:, j].numpy(), col[:, 0].numpy())


def _scalar_partitioned(d, e, b, dt):
    """The partitioned kernels' order of operations over numpy scalars of
    type dt: rows past n read diagonal 1, offdiag 0 and rhs 0, as the
    kernels' bounds checks do."""
    n = d.shape[0]
    if n <= L:
        return _scalar_thomas(d, e, b, dt)
    z, one = dt(0), dt(1)
    nb = -(-n // L)
    w = L - 1
    dd = lambda i: d[i] if i < n else one  # noqa: E731
    ee = lambda i: e[i] if i < n - 1 else z  # noqa: E731
    bb = lambda i: b[i] if i < n else z  # noqa: E731
    R, C, VL, VR, Y = (np.zeros(nb * L, dt) for _ in range(5))
    for k in range(nb):  # part_factor and part_sweep
        base = k * L
        e_left = ee(base - 1) if k > 0 else z
        c_prev = h_prev = g_prev = e_prev = z
        hh, gg = [], []
        for j in range(w):
            i = base + j
            r = dt(one / dt(dd(i) - dt(e_prev * c_prev)))
            c_prev = dt(ee(i) * r)
            h_prev = dt(dt((e_left if j == 0 else z) - dt(e_prev * h_prev)) * r)
            g_prev = dt(dt(bb(i) - dt(e_prev * g_prev)) * r)
            R[i], C[i] = r, c_prev
            hh.append(h_prev)
            gg.append(g_prev)
            e_prev = ee(i)
        vl, vr, y = hh[-1], C[base + w - 1], gg[-1]
        VL[base + w - 1], VR[base + w - 1], Y[base + w - 1] = vl, vr, y
        for j in range(w - 2, -1, -1):
            i = base + j
            vl = dt(hh[j] - dt(C[i] * vl))
            vr = -dt(C[i] * vr)
            y = dt(gg[j] - dt(C[i] * y))
            VL[i], VR[i], Y[i] = vl, vr, y
    D, E, B = np.zeros(nb, dt), np.zeros(nb - 1, dt), np.zeros(nb, dt)
    for k in range(nb):  # part_assemble
        s = k * L + w
        nxt = k + 1 < nb
        e_r, e_s = ee(s - 1), ee(s)
        y_next = Y[s + 1] if nxt else z
        B[k] = dt(dt(bb(s) - dt(e_r * Y[s - 1])) - dt(e_s * y_next))
        D[k] = dt(dt(dd(s) - dt(e_r * VR[s - 1])) - dt(e_s * (VL[s + 1] if nxt else z)))
        if nxt:
            E[k] = -dt(e_s * VR[s + 1])
    X = _scalar_partitioned(D, E, B, dt)
    x = np.zeros(n, dt)
    for i in range(n):  # part_backfill
        k = i // L
        if i % L == w:
            x[i] = X[k]
        else:
            x_left = X[k - 1] if k > 0 else z
            x[i] = dt(dt(Y[i] - dt(x_left * VL[i])) - dt(X[k] * VR[i]))
    return x


@pytest.mark.parametrize("n", [L + 1, 3 * L, L * L + 5])
@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_partitioned_plain_version_is_the_kernel_order(dt, n):
    d, e, b = (a.astype(dt) for a in _cspline_system(n, n + L))
    B = np.stack([b, b[::-1].copy()], -1)
    got = tridiag.partitioned_ref(torch.tensor(d), torch.tensor(e), torch.tensor(B)).numpy()
    for j in range(2):
        np.testing.assert_array_equal(got[:, j], _scalar_partitioned(d, e, B[:, j], dt))


def test_partition_plan():
    assert tridiag.partition_plan(999_998) == [999_998, 31_250, 977, 31]
    assert tridiag.partition_plan(2046) == [2046, 64, 2]
    assert tridiag.partition_plan(L) == [L]
    assert tridiag.partition_plan(L + 1) == [L + 1, 2]
    assert tridiag.kernels_per_solve(999_998, 1) == 10
    assert tridiag.kernels_per_solve(999_999, 2) == 10
    assert tridiag.kernels_per_solve(2046, 2048) == 9
    assert tridiag.kernels_per_solve(L * L, 3) == 5
    assert tridiag.kernels_per_solve(L, 1) == 1


def test_partitioned_cuda_wrapper_refuses_cpu_tensors():
    d, e, b = (torch.tensor(a) for a in _system(50, 1))
    with pytest.raises(errors.InvalidArgumentError):
        tridiag.partitioned_cuda(d, e, b[:, None])
