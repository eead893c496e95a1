"""Port's ops/tridiag.py vs the JAX package's lax.scan solvers, on the CPU.

XLA on the CPU may contract a multiply and an add into one rounding where
the port rounds twice, so the port is held within 1e-14 of the solution's
scale in float64 and 4 ulps of it in float32.  The plain version is held
bit-equal to a scalar loop in the kernel's order of operations.
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
