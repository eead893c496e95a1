"""Port's models/rbf.py and ops/morton.py vs the JAX package, on the CPU.

The same numpy inputs go through the JAX function and the port's.  Float64
tolerances follow tests/test_rbf.py; JAX fits are module-scoped and shared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import rbf as jrbf
from gsl_scattered_interpolation_tpu.ops import morton as jmorton

from gsl_scattered_interpolation_torch.models import convert, rbf
from gsl_scattered_interpolation_torch.ops import morton
from gsl_scattered_interpolation_torch.utils import errors

KERNELS = sorted(rbf.KERNELS)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores, and eight threads per worker oversubscribe them many times over
    on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sites(n=80, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, d))
    f = np.sin(2 * x[:, 0]) * np.cos(x[:, 1] if d > 1 else 0.0)
    return x, f


def _eps(kernel):
    # The weights of a system of condition number kappa are fixed only to
    # about kappa * eps * |lam|, whoever solves it: at tests/test_rbf.py's
    # gaussian epsilon of 2 kappa is 6e13 and two LAPACKs' weights differ in
    # the third digit.  These shapes keep kappa <= 1.5e7 at n = 80.
    return {"wendland_c2": 2.0, "gaussian": 8.0, "multiquadric": 8.0,
            "inverse_multiquadric": 8.0}.get(kernel)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def direct():
    """{kernel: (JAX fit, port fit)} at n = 80, float64."""
    x, f = _sites()
    out = {}
    for k in KERNELS:
        ref = jrbf.RbfInterp(x, f, kernel=k, epsilon=_eps(k))
        ours = rbf.RbfInterp(x, f, kernel=k, epsilon=_eps(k), device=CPU)
        out[k] = (ref, ours)
    return out


def test_morton_order_equal():
    rng = np.random.default_rng(0)
    for pts in (rng.uniform(-3, 5, (5000, 2)), rng.integers(0, 7, (400, 2)).astype(float)):
        np.testing.assert_array_equal(morton.morton_order(pts), jmorton.morton_order(pts))
        np.testing.assert_array_equal(
            morton.morton_order(pts, bits=10), jmorton.morton_order(pts, bits=10))


@pytest.mark.parametrize("kernel", KERNELS)
def test_phi_matches_jax(kernel):
    r = np.concatenate([[0.0], np.random.default_rng(1).uniform(0, 3, 4000)])
    phi_j, phi = jrbf.KERNELS[kernel].phi, rbf.KERNELS[kernel].phi
    assert rbf.KERNELS[kernel][1:] == (phi, *jrbf.KERNELS[kernel][2:])
    want = np.asarray(phi_j(jnp.asarray(r), 2.0))
    got = _np(phi(torch.tensor(r), 2.0))
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    # float32: torch.log against the JAX package's accurate.log
    r32 = r.astype(np.float32)
    want = np.asarray(phi_j(jnp.asarray(r32), np.float32(2.0)))
    got = _np(phi(torch.tensor(r32), 2.0))
    assert got.dtype == np.float32
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= 4 * ulp), np.max(np.abs(got - want) / ulp)


def test_pairwise_dist_matches_jax():
    rng = np.random.default_rng(2)
    a, b = rng.uniform(-1, 1, (300, 2)), rng.uniform(-1, 1, (200, 2))
    want = np.asarray(jrbf.pairwise_dist(jnp.asarray(a), jnp.asarray(b)))
    got = _np(rbf.pairwise_dist(torch.tensor(a), torch.tensor(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    want = np.asarray(jrbf.pairwise_d2(jnp.asarray(a), jnp.asarray(a)))
    got = _np(rbf.pairwise_d2(torch.tensor(a), torch.tensor(a)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


@pytest.mark.parametrize("kernel", KERNELS)
def test_direct_matches_jax(direct, kernel):
    ref, ours = direct[kernel]
    assert ours.solver == "direct" and ours.lam.dtype == torch.float64
    lam = np.asarray(ref.lam)
    tol = 1e-9 * max(1.0, np.abs(lam).max())
    np.testing.assert_allclose(_np(ours.lam), lam, rtol=0, atol=tol)
    np.testing.assert_allclose(_np(ours.poly_coef), np.asarray(ref.poly_coef), rtol=0, atol=tol)
    q = np.random.default_rng(3).uniform(-1.1, 1.1, (300, 2))
    want = np.asarray(ref.eval(q))
    np.testing.assert_allclose(_np(ours.eval(q)), want, rtol=0, atol=1e-9)
    x, f = _sites()
    np.testing.assert_allclose(_np(ours.eval(x)), f, rtol=0, atol=5e-8)
    assert float(ours.residual()) < 5e-8
    # the JAX fit carried into the port evaluates as JAX does
    carried = convert.rbf_interp_from_jax({
        "kernel": kernel, "epsilon": ref.epsilon, "smooth": ref.smooth,
        "shift": ref.shift, "scale": ref.scale, "xs": np.asarray(ref.xs),
        "values": np.asarray(ref.values), "lam": lam,
        "poly_coef": np.asarray(ref.poly_coef)}, device=CPU)
    np.testing.assert_allclose(_np(carried.eval(q)), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kernel", ["thin_plate", "gaussian"])
def test_eval_deriv_matches_jax(direct, kernel):
    ref, ours = direct[kernel]
    q = np.random.default_rng(4).uniform(-0.9, 0.9, (20, 2))
    np.testing.assert_allclose(
        _np(ours.eval_deriv(q)), np.asarray(ref.eval_deriv(q)), rtol=0, atol=1e-8)


def test_1d_and_3d_direct():
    for d in (1, 3):
        x, f = _sites(40, d, 8 + d)
        ref = jrbf.RbfInterp(x, f, kernel="thin_plate")
        ours = rbf.RbfInterp(x, f, kernel="thin_plate", device=CPU)
        q = np.random.default_rng(d).uniform(-1, 1, (50, d))
        np.testing.assert_allclose(_np(ours.eval(q)), np.asarray(ref.eval(q)), rtol=0, atol=1e-9)


def test_dtype_defaults_and_float32():
    x, f = _sites()
    ours = rbf.RbfInterp(x, f, kernel="thin_plate", dtype=torch.float32, device=CPU)
    assert ours.lam.dtype == torch.float32
    assert float(ours.residual()) < 1e-3


# Converged values: the systems of tests/test_rbf.py at a tolerance of 1e-12.
def test_cg_matches_jax():
    # Compactly supported kernel: strictly PD, CG's intended path.
    x, f = _sites(200, 2, 11)
    kw = dict(kernel="wendland_c2", epsilon=6.0, solver="cg", cg_tol=1e-12,
              cg_maxiter=2000, block=64)
    ref = jrbf.RbfInterp(x, f, **kw)
    ours = rbf.RbfInterp(x, f, device=CPU, **kw)
    np.testing.assert_allclose(_np(ours.lam), np.asarray(ref.lam), rtol=0, atol=1e-8)
    q = np.random.default_rng(10).uniform(-0.9, 0.9, (100, 2))
    np.testing.assert_allclose(_np(ours.eval(q)), np.asarray(ref.eval(q)), rtol=0, atol=1e-8)


def test_projected_cg_matches_jax():
    x, f = _sites(150, 2, 12)
    kw = dict(kernel="thin_plate", solver="cg", cg_tol=1e-12, cg_maxiter=4000, block=64)
    ref = jrbf.RbfInterp(x, f, **kw)
    ours = rbf.RbfInterp(x, f, device=CPU, **kw)
    np.testing.assert_allclose(_np(ours.lam), np.asarray(ref.lam), rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(ours.poly_coef), np.asarray(ref.poly_coef), rtol=0, atol=1e-8)
    q = np.random.default_rng(13).uniform(-0.9, 0.9, (150, 2))
    np.testing.assert_allclose(_np(ours.eval(q)), np.asarray(ref.eval(q)), rtol=0, atol=1e-8)


def _stopped_at(run, it, full):
    """JAX's loop (``run(maxiter)``) stopped after exactly ``it`` iterations:
    capping it there changes nothing, capping it one earlier does."""
    at = np.asarray(run(it))
    np.testing.assert_array_equal(at, full)
    assert not np.array_equal(np.asarray(run(it - 1)), at)


# The iteration count.  CG's residual norms are erratic on ill-conditioned
# systems: on the thin-plate system above JAX's own jit and eager runs
# differ 2x in |r| by iteration 21, so which iterate first passes 1e-12
# there is decided by rounding.  On these well-conditioned systems every
# iteration cuts |r| clearly, and the port must stop where JAX stops.
@pytest.mark.parametrize("kernel,epsilon,smooth", [
    ("wendland_c2", 20.0, 0.0),  # plain CG
    ("thin_plate", None, 1.0),   # projected CG
])
def test_cg_stops_where_jax_stops(kernel, epsilon, smooth):
    x, f = _sites(200, 2, 11)
    kw = dict(kernel=kernel, epsilon=epsilon, smooth=smooth, solver="cg",
              cg_tol=1e-10, cg_maxiter=500, block=64)
    ref = jrbf.RbfInterp(x, f, **kw)
    ours = rbf.RbfInterp(x, f, device=CPU, **kw)
    it = ours.solve_info["iters"]
    assert 4 < it < 500
    phi = jrbf.KERNELS[kernel].phi
    if kernel == "thin_plate":
        P = jrbf._poly_basis(ref.xs, 1)
        run = lambda mi: jrbf._projected_cg_matfree(  # noqa: E731
            ref.xs, ref.values, P, phi, ref.epsilon, smooth, 1e-10, mi, 64)[0]
    else:
        run = lambda mi: jrbf._cg_matfree(  # noqa: E731
            ref.xs, ref.values, phi, epsilon, smooth, 1e-10, mi, 64)
    _stopped_at(run, it, np.asarray(ref.lam))
    np.testing.assert_allclose(_np(ours.lam), np.asarray(ref.lam), rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def pcg():
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, size=(300, 2))
    f = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1])
    kw = dict(kernel="thin_plate", solver="pcg", cg_tol=1e-12, cg_maxiter=500, block=128)
    return x, f, jrbf.RbfInterp(x, f, **kw), rbf.RbfInterp(x, f, device=CPU, **kw)


def test_pcg_matches_jax(pcg):
    x, f, ref, ours = pcg
    assert ours.solve_info["iters"] == ref.solve_info["iters"]
    assert ours.solve_info["rel_residual"] < 1e-12
    q = np.random.default_rng(5).uniform(-0.9, 0.9, (400, 2))
    np.testing.assert_allclose(_np(ours.eval(q)), np.asarray(ref.eval(q)), rtol=0, atol=1e-7)
    np.testing.assert_allclose(_np(ours.eval(x)), f, rtol=0, atol=1e-7)


def test_local_lagrange_rows_match_jax(pcg):
    x, _, ref, _ = pcg
    order = morton.morton_order(np.asarray(ref.xs))
    xs_m = np.asarray(ref.xs)[order]
    phi_j, phi = jrbf.KERNELS["thin_plate"].phi, rbf.KERNELS["thin_plate"].phi
    pre_j = jrbf._local_lagrange_precond(jnp.asarray(xs_m), phi_j, ref.epsilon, 3)
    apply, C = rbf._local_lagrange_precond(torch.tensor(xs_m), phi, ref.epsilon, 3)
    n = xs_m.shape[0]
    # column j of the dense operator is C e_j, row i of C_dense is C[i]
    want = np.stack([np.asarray(pre_j.raw(jnp.eye(n)[j])) for j in range(n)], 1)
    got = np.stack([_np(apply(torch.eye(n, dtype=torch.float64)[j])) for j in range(n)], 1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * scale)
    assert C.shape == (n, 50 + 12)


def test_singular_and_arguments():
    x = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    with pytest.raises(errors.SingularError):
        rbf.RbfInterp(x, np.arange(4.0), kernel="thin_plate", device=CPU)
    with pytest.raises(errors.SingularError):
        rbf.RbfInterp(x, np.arange(4.0), kernel="gaussian", device=CPU)
    with pytest.raises(errors.InvalidArgumentError):
        rbf.RbfInterp(np.zeros((5, 2)), np.zeros(5), kernel="cauchy", device=CPU)
    with pytest.raises(errors.InvalidArgumentError):
        rbf.RbfInterp(np.zeros((5, 2)), np.zeros(4), device=CPU)


def test_while_loop_freezes_at_jax_stop():
    # 11 steps to reach the bound, with a host read every CHECK_EVERY.
    def cond(s):
        return (s[0] < 11) & (s[1] < 100)

    def body(s):
        return s[0] + 1, s[1] + 1

    x, it = rbf.while_loop(cond, body, (torch.tensor(0), torch.tensor(0)))
    assert int(x) == 11 and int(it) == 11
    x, it = rbf.while_loop(cond, body, (torch.tensor(20), torch.tensor(0)))
    assert int(x) == 20 and int(it) == 0
