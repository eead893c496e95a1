"""Port's models/kriging.py vs the JAX package, on the CPU, in float64.

Above 2,000 sites the variogram is fitted on a random subsample, which the
port cannot draw as JAX does; the tests pass JAX's subsample index, or
JAX's fitted Variogram.
"""

import jax
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import kriging as jkr
from gsl_scattered_interpolation_tpu.utils import datasets

from gsl_scattered_interpolation_torch.models import convert, kriging
from gsl_scattered_interpolation_torch.utils import errors

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


def _field(n=120, seed=0, d=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, size=(n, d))
    f = np.sin(x[:, 0] * 0.8) + 0.5 * np.cos(x[:, 1] * 1.1)
    if d == 3:
        f = f - 0.2 * x[:, 2]
    return x, f


def _std(x):
    lo, hi = x.min(0), x.max(0)
    return (x - (lo + hi) / 2) / np.where(hi > lo, hi - lo, 1)


def _vg_equal(ours, ref, tol):
    assert ours.model == ref.model
    for a, b in zip(ours[1:], ref[1:]):
        assert a == pytest.approx(b, rel=tol, abs=tol)


@pytest.mark.parametrize("model", sorted(kriging.VARIOGRAM_MODELS))
def test_variogram_models_match_jax(model):
    h = np.concatenate([[0.0], np.random.default_rng(1).uniform(0, 3, 1000)])
    ref = jkr.Variogram(model, nugget=0.1, sill=2.0, range_=0.7)
    ours = convert.variogram_from_jax(ref)
    assert ours == kriging.Variogram(model, 0.1, 2.0, 0.7)
    want = np.asarray(ref(h))
    got = ours(torch.tensor(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-15)
    assert got[0] == 0.0


@pytest.mark.parametrize("n", [120, 3000])
def test_empirical_variogram_matches_jax(n):
    x, f = _field(n, seed=2)
    xs = _std(x)
    want = jkr.empirical_variogram(xs, f)
    key = 0
    if n > 2000:  # JAX's subsample (kriging.py:113)
        key = np.asarray(jax.random.choice(jax.random.key(0), n, (2000,), replace=False))
    got = kriging.empirical_variogram(torch.tensor(xs), torch.tensor(f), key=key)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    vg = kriging.fit_variogram(*got)
    _vg_equal(vg, jkr.fit_variogram(*want), 1e-10)


def test_empirical_variogram_int_key_subsamples():
    x, f = _field(2500, seed=3)
    t = torch.tensor(_std(x)), torch.tensor(f)
    a = kriging.empirical_variogram(*t, key=5)
    b = kriging.empirical_variogram(*t, key=5)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert float(a[2].sum()) <= 2000 * 1999 / 2
    with pytest.raises(errors.InvalidArgumentError):
        kriging.empirical_variogram(*t, key=np.arange(10))


@pytest.mark.parametrize("model", sorted(kriging.VARIOGRAM_MODELS))
def test_fit_variogram_matches_jax(model):
    # test_kriging.py's synthetic variogram: a clear SSE minimum.
    truth = jkr.Variogram(model, nugget=0.2, sill=1.5, range_=0.4)
    h = np.linspace(0.01, 0.8, 20)
    g = np.asarray(truth(h))
    w = np.full(20, 100.0)
    ours = kriging.fit_variogram(h, g, w, model=model)
    _vg_equal(ours, jkr.fit_variogram(h, g, w, model=model), 1e-10)
    with pytest.raises(errors.InvalidArgumentError):
        kriging.fit_variogram(h, g, w, model="cubic")


def test_ordinary_kriging_matches_jax():
    x, f = _field(80, 1)
    q = np.concatenate([np.random.default_rng(4).uniform(0, 10, (60, 2)), [[50.0, 50.0]]])
    vg = jkr.Variogram("exponential", nugget=0.0, sill=1.0, range_=0.5)
    for given in (vg, None):
        ref = jkr.OrdinaryKriging(x, f, variogram=given)
        ours = kriging.OrdinaryKriging(
            x, f, variogram=given and convert.variogram_from_jax(given), device=CPU)
        _vg_equal(ours.variogram, ref.variogram, 1e-10)
        m, v = ours.predict(q)
        m_j, v_j = ref.predict(q)
        np.testing.assert_allclose(m.numpy(), np.asarray(m_j), rtol=0, atol=1e-9)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ours.eval(x).numpy(), f, rtol=0, atol=1e-6)


def test_weather_auto_variogram_matches_jax():
    sites, temps = datasets.weather()
    ref = jkr.OrdinaryKriging(sites, temps)
    ours = kriging.OrdinaryKriging(sites, temps, device=CPU)
    _vg_equal(ours.variogram, ref.variogram, 1e-10)
    # The fitted variogram is pure nugget (sill 1e-12): the saddle matrix's
    # condition number is 1.7e16, so two LU solvers agree on the means only
    # to about 1e-4 relative.  test_kriging.py's own checks:
    mean, var = ours.predict(np.array([[-88.0, 41.5], [-88.5, 42.0]]))
    assert bool(torch.isfinite(mean).all()) and bool((var >= 0).all())
    assert 260 < float(mean[0]) < 300


@pytest.mark.parametrize("d,n,k", [(2, 3000, 24), (3, 600, 16)])
def test_local_kriging_matches_jax(d, n, k):
    x, f = _field(n, 5, d)
    vg = jkr.LocalKriging(x, f, k_neighbors=k).variogram  # JAX's subsampled fit
    ref = jkr.LocalKriging(x, f, variogram=vg, k_neighbors=k)
    ours = kriging.LocalKriging(x, f, variogram=convert.variogram_from_jax(vg), k_neighbors=k,
                                device=CPU)
    assert ours.variogram_subsampled == (n > 2000)
    q = np.concatenate([np.random.default_rng(6).uniform(-0.5, 10.5, (700, d)), x[:50],
                        [[50.0] * d]])
    m, v = ours.predict(q)
    m_j, v_j = ref.predict(q)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), rtol=0, atol=1e-8)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=0, atol=1e-8)
    # chunked predict equals unchunked
    mc, vc = ours.predict(q, chunk=97)
    np.testing.assert_allclose(mc.numpy(), m.numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(vc.numpy(), v.numpy(), rtol=0, atol=1e-14)


@pytest.mark.parametrize("d,n", [(2, 48), (3, 40)])
def test_local_equals_dense_when_k_covers_all(d, n):
    # test_kriging.py:95 and its 3D case
    x, f = _field(n, 3 if d == 2 else 9, d)
    vg = kriging.Variogram("exponential", nugget=0.0, sill=1.0, range_=0.5)
    dense = kriging.OrdinaryKriging(x, f, variogram=vg, device=CPU)
    local = kriging.LocalKriging(x, f, variogram=vg, k_neighbors=n, target_per_cell=200.0,
                                 device=CPU)
    q = np.random.default_rng(4).uniform(1, 9, size=(200, d))
    m_d, v_d = dense.predict(q)
    m_l, v_l = local.predict(q)
    np.testing.assert_allclose(m_l.numpy(), m_d.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(v_l.numpy(), v_d.numpy(), rtol=0, atol=1e-7)
    ref = jkr.LocalKriging(x, f, variogram=jkr.Variogram(*vg), k_neighbors=n, target_per_cell=200.0)
    np.testing.assert_allclose(m_l.numpy(), np.asarray(ref.predict(q)[0]), rtol=0, atol=1e-8)


def test_local_kriging_float32_and_exactness():
    x, f = _field(2000, 7)
    vg = kriging.Variogram("exponential", nugget=0.0, sill=1.0, range_=0.2)
    m64 = kriging.LocalKriging(x, f, variogram=vg, device=CPU)
    m32 = kriging.LocalKriging(x, f, variogram=vg, dtype=torch.float32, device=CPU)
    mean, var = m64.predict(x[:300])
    np.testing.assert_allclose(mean.numpy(), f[:300], rtol=0, atol=1e-5)
    assert float(var.max()) < 1e-5
    q = np.random.default_rng(8).uniform(0.5, 9.5, (500, 2))
    a, va = m32.predict(q)
    b, vb = m64.predict(q)
    assert a.dtype == torch.float32
    assert np.max(np.abs(a.numpy() - b.numpy())) < 1e-3
    assert bool((va >= 0).all()) and bool(torch.isfinite(va).all())
    _, v_far = m64.predict(np.array([[50.0, 50.0]]))
    assert float(v_far[0]) > 0.5
