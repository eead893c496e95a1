"""Port's models/rbf_compact.py vs the JAX package, on the CPU, and the
repair of the stencil's wrap-around on grids of 1 or 2 cells per axis."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import rbf as jrbf
from gsl_scattered_interpolation_tpu.models import rbf_compact as jrc

from gsl_scattered_interpolation_torch.models import convert, rbf, rbf_compact

CPU = "cpu"
PHI = rbf.KERNELS["wendland_c2"].phi
JPHI = jrbf.KERNELS["wendland_c2"].phi


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores, and eight threads per worker oversubscribe them many times over
    on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n, seed=0):
    rng = np.random.default_rng(seed)
    sites = rng.uniform(-2.0, 3.0, size=(n, 2))
    vals = np.sin(2.0 * sites[:, 0]) * np.cos(sites[:, 1])
    return sites, vals


def _std(sites):
    lo, hi = sites.min(0), sites.max(0)
    return (sites - (lo + hi) / 2) / (hi - lo)


def _grids(xs, rho):
    return jrc.build_cell_grid(xs, rho), rbf_compact.build_cell_grid(xs, rho, device=CPU)


def _dense_matvec(xs, eps, v):
    diff = xs[:, None, :] - xs[None, :, :]
    return rbf_compact._phi64(np.sqrt((diff**2).sum(-1)), eps) @ v


@pytest.mark.parametrize("n,d,rho", [(777, 2, 0.03), (400, 2, 0.07), (300, 3, 0.2), (60, 2, 0.9)])
def test_build_cell_grid_equal(n, d, rho):
    xs = _std(np.random.default_rng(n).uniform(-2, 3, (n, d)))
    ref, ours = _grids(xs, rho)
    np.testing.assert_array_equal(ours.xs_pad.numpy(), np.asarray(ref.xs_pad))
    np.testing.assert_array_equal(ours.slot_site.numpy(), np.asarray(ref.slot_site))
    np.testing.assert_array_equal(ours.origin.numpy(), np.asarray(ref.origin))
    # (JAX's CellGrid.cap reads axis 2, the capacity only in 2D)
    assert (ours.n_sites, ours.cell_size, ours.cap) == (ref.n_sites, ref.cell_size, ref.xs_pad.shape[-2])
    host = rbf_compact.build_cell_grid(xs, rho, as_numpy=True)
    np.testing.assert_array_equal(host.xs_pad, np.asarray(ref.xs_pad))
    carried = convert.cell_grid_from_jax(ref._asdict(), device=CPU)
    np.testing.assert_array_equal(carried.slot_site.numpy(), ours.slot_site.numpy())


def test_pack_unpack_exact():
    sites, vals = _problem(400)
    ref, ours = _grids(_std(sites), 0.07)
    packed = rbf_compact.pack_values(ours, torch.tensor(vals))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jrc.pack_values(ref, jnp.asarray(vals))))
    back = rbf_compact.unpack_values(ours, packed)
    np.testing.assert_array_equal(back.numpy(), vals)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jrc.unpack_values(ref, jrc.pack_values(ref, jnp.asarray(vals)))))


@pytest.mark.parametrize("n,eps", [(500, 8.0), (300, 3.5)])
def test_matvec_pad_matches_jax(n, eps):
    # 3 or more cells per axis: the masked wrap terms are exact zeros.
    sites, vals = _problem(n, seed=1)
    xs = _std(sites)
    ref, ours = _grids(xs, 1.0 / eps)
    assert min(ours.shape) >= 3
    want = np.asarray(jrc.unpack_values(ref, jrc.matvec_pad(
        ref, JPHI, eps, 0.25, jrc.pack_values(ref, jnp.asarray(vals)))))
    got = rbf_compact.unpack_values(ours, rbf_compact.matvec_pad(
        ours, PHI, eps, 0.25, rbf_compact.pack_values(ours, torch.tensor(vals)))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, _dense_matvec(xs, eps, vals) + 0.25 * vals, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def fit777():
    sites, vals = _problem(777, seed=3)
    kw = dict(tol=1e-12, maxiter=5000)
    return sites, vals, jrc.CompactRbf(sites, vals, **kw), rbf_compact.CompactRbf(sites, vals, device=CPU, **kw)


def test_compact_rbf_matches_jax(fit777):
    sites, vals, ref, ours = fit777
    assert ours.grid.xs_pad.dtype == torch.float64
    assert ours.grid.shape == ref.grid.shape and min(ours.grid.shape) >= 3
    np.testing.assert_allclose(ours.lam.numpy(), np.asarray(ref.lam), rtol=0, atol=1e-8)
    q = np.random.default_rng(5).uniform(-1.5, 2.5, size=(300, 2))
    np.testing.assert_allclose(ours.eval(q).numpy(), np.asarray(ref.eval(q)), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ours.eval(sites).numpy(), vals, rtol=0, atol=1e-9)
    assert float(ours.residual()) < 1e-9
    assert abs(ours.cg_iters - ref.cg_iters) <= max(2, ref.cg_iters // 20)
    assert ours.cg_residual <= 1e-12 * np.linalg.norm(vals)


def test_carried_fit_evaluates_as_jax(fit777):
    sites, vals, ref, _ = fit777
    carried = convert.compact_rbf_from_jax({
        "grid": ref.grid._asdict(), "epsilon": ref.epsilon, "smooth": ref.smooth,
        "shift": ref.shift, "scale": ref.scale, "values": np.asarray(ref.values),
        "lam_pad": np.asarray(ref.lam_pad)}, device=CPU)
    q = np.random.default_rng(6).uniform(-1.5, 2.5, size=(300, 2))
    np.testing.assert_allclose(carried.eval(q).numpy(), np.asarray(ref.eval(q)), rtol=0, atol=1e-12)
    assert float(carried.residual()) == pytest.approx(float(ref.residual()), abs=1e-13)


def test_cg_pad_matches_jax():
    sites, vals = _problem(400, seed=4)
    ref, ours = _grids(_std(sites), 1.0 / 12.0)
    x_j, rs_j, it_j = jrc._cg_pad(ref, JPHI, 12.0, 0.0, jrc.pack_values(ref, jnp.asarray(vals)), 1e-12, 3000)
    x, rs, it = rbf_compact._cg_pad(ours, PHI, 12.0, 0.0, rbf_compact.pack_values(ours, torch.tensor(vals)), 1e-12, 3000)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=0, atol=1e-8)
    assert float(rs) <= 1e-24 * float(vals @ vals) and int(it_j) > 10


def test_block_jacobi_inverse_matches_jax():
    sites, _ = _problem(400, seed=4)
    ref, ours = _grids(_std(sites), 1.0 / 12.0)
    want = np.asarray(jrc._block_jacobi_inv(ref, JPHI, 12.0, 0.0))
    got = rbf_compact._block_jacobi_inv(ours, PHI, 12.0, 0.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())


def _oracle(sites, values, eps):
    diff = sites[:, None, :] - sites[None, :, :]
    return np.linalg.solve(rbf_compact._phi64(np.sqrt((diff**2).sum(-1)), eps), values)


def test_refine_float32_reaches_1e6():
    # tests/test_weight_accuracy.py:79-96, through the port alone.
    rng = np.random.default_rng(11)
    sites = rng.uniform(-0.5, 0.5, size=(1024, 2))
    values = np.sin(3 * sites[:, 0]) * np.cos(2 * sites[:, 1])
    eps = 1.0 / float(np.sqrt(40.0 / (np.pi * len(sites))))
    m = rbf_compact.CompactRbf(sites, values, epsilon=eps, tol=1e-7, maxiter=4000,
                               standardize=False, dtype=torch.float32, device=CPU)
    lam64 = _oracle(sites, values, eps)
    rel32 = np.max(np.abs(m.lam.numpy().astype(np.float64) - lam64)) / np.max(np.abs(lam64))
    assert rel32 <= 1e-2, rel32
    m.refine(iters=3)
    rel = np.max(np.abs(m.lam64 - lam64)) / np.max(np.abs(lam64))
    assert rel <= 1e-6, (rel, m.refine_history)
    h = m.refine_history
    assert len(h) == 4 and h[-1] < h[0], h
    assert m.lam.dtype == torch.float32


# The repair.  JAX's matvec_pad rolls the 9 stencil offsets around the
# grid and counts on wrapped pairs lying outside the support; with 1 or 2
# cells per axis roll(-1) and roll(+1) reach the same cell, which is then
# counted two to nine times.  The default support gives such grids below
# about 115 sites.
@pytest.mark.parametrize("eps,cells", [(0.8, (1, 1)), (2.5, (2, 2))])
def test_matvec_pad_repaired_on_small_grids(eps, cells, monkeypatch):
    xs = np.random.default_rng(0).uniform(-0.5, 0.5, (60, 2))
    v = np.sin(3 * xs[:, 0]) + xs[:, 1]
    want = _dense_matvec(xs, eps, v)
    ref, ours = _grids(xs, 1.0 / eps)
    assert ours.shape == cells == ref.shape
    got = rbf_compact.unpack_values(ours, rbf_compact.matvec_pad(
        ours, PHI, eps, 0.0, rbf_compact.pack_values(ours, torch.tensor(v)))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    theirs = np.asarray(jrc.unpack_values(ref, jrc.matvec_pad(
        ref, JPHI, eps, 0.0, jrc.pack_values(ref, jnp.asarray(v)))))
    assert np.max(np.abs(theirs - want)) > 1.0  # the fault the port repairs
    # the host float64 matvec's cell-list route, forced at 60 sites
    monkeypatch.setattr(rbf_compact, "HOST_DENSE_MAX", 10)
    np.testing.assert_allclose(rbf_compact._host_matvec_f64(xs, eps, 0.0, v), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n,cells", [(60, (2, 2)), (100, (2, 2))])
def test_compact_rbf_interpolates_on_small_grids(n, cells):
    sites = np.random.default_rng(0).uniform(-1, 1, (n, 2))
    vals = np.sin(3 * sites[:, 0]) * np.cos(2 * sites[:, 1])
    m = rbf_compact.CompactRbf(sites, vals, tol=1e-12, maxiter=2000, device=CPU)
    assert m.grid.shape == cells
    np.testing.assert_allclose(m.eval(sites).numpy(), vals, rtol=0, atol=1e-9)
    assert float(m.residual()) < 1e-9
    ref = jrc.CompactRbf(sites, vals, tol=1e-12, maxiter=2000)
    assert np.max(np.abs(np.asarray(ref.eval(sites)) - vals)) > 0.1  # JAX's fit misses
