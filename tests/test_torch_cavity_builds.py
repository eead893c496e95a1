"""Whole 3D (and 4D) cavity builds of the port (models/device_cavity.py)
against the JAX package's, as sets of simplexes, as in
tests/test_device_cavity.py.

The JAX builds pad the sites to a shape bucket (256 sites at least), so
their slot counts differ from the port's and whole builds are compared as
sets.  The port takes the JAX insertion order through ``key``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import device_cavity as jdc
from gsl_scattered_interpolation_tpu.models import device_tri as jdt
from gsl_scattered_interpolation_tpu.models import host_tree as jht

from gsl_scattered_interpolation_torch.models import device_cavity as dc
from gsl_scattered_interpolation_torch.utils import integrity

DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores, and eight threads per worker oversubscribe them many times over
    on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(n, d, seed):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, size=(n, d))


def _lattice():
    g = np.linspace(-0.4, 0.4, 5)
    return np.stack([a.ravel() for a in np.meshgrid(g, g, g)], axis=1)


def _canon(tv, shuffle, d):
    """The simplex set in user row ids (cage ids stay 0..d)."""
    inv = np.concatenate([np.arange(d + 1), np.asarray(shuffle) + d + 1])
    return {tuple(sorted(r)) for r in inv[np.asarray(tv)].tolist()}


# name: (sites, dtype, JAX triangulate keywords, port triangulate keywords)
BUILDS = {
    "n1": (lambda: _rand(1, 3, 101), "f64", {}, {}),
    "n5": (lambda: _rand(5, 3, 105), "f64", {}, {}),
    "n40": (lambda: _rand(40, 3, 140), "f64", {}, {}),
    "n300": (lambda: _rand(300, 3, 400), "f64", {}, {}),
    "f32_n60": (lambda: _rand(60, 3, 60), "f32", {}, {}),
    # The JAX package's own test (TestCavity4D::test_matches_host_oracle)
    # finds its 4D device build equal to its host engine's on these sites;
    # the host engine is the reference here, at a tenth of the JAX 4D
    # build's compile time.
    "4d_n60": (lambda: _rand(60, 4, 44), "f64", "host", {}),
    "seeded_n400": (lambda: _rand(400, 3, 21), "f64", {"seed_min": 64}, {"seed_min": 64}),
    "lattice": (_lattice, "f64", {}, {}),
    # A cavity capacity of 1 strands every round until C escalates; JAX's
    # own test finds its escalated build equal to its default build, which
    # is the reference here.
    "escalation": (lambda: _rand(120, 3, 7), "f64", {}, {"cavity_cap": 1}),
}

_JAX = {}


def _jax_build(name):
    """JAX triangulate of a case: (simplex set, shuffle), computed once."""
    if name not in _JAX:
        sites, dt, jkw, _ = BUILDS[name]
        sites = sites()
        if jkw == "host":
            tree = jht.build(sites, flags=jht.NOSTANDARDIZE, key=0)
            jtri, shuffle = jdt.freeze(tree), tree.shuffle[: len(sites)]
        else:
            jtri, shuffle = jdc.triangulate(sites, flags=jht.NOSTANDARDIZE, key=0, dtype=DTYPES[dt][0], **jkw)
        _JAX[name] = _canon(jtri.tri_verts, shuffle, sites.shape[1]), np.asarray(shuffle)
    return _JAX[name]


@pytest.mark.parametrize("name", list(BUILDS))
def test_triangulate_set_equal_jax(name):
    sites, dt, _, kw = BUILDS[name]
    sites = sites()
    n, d = sites.shape
    ref, shuffle = _jax_build(name)
    stats = {}
    tri, sh = dc.triangulate(
        sites, flags=jht.NOSTANDARDIZE, key=shuffle, dtype=DTYPES[dt][1], device="cpu", stats=stats, **kw
    )
    np.testing.assert_array_equal(sh, shuffle)
    assert _canon(tri.tri_verts.numpy(), sh, d) == ref
    assert tri.dtype == torch.float64 and tri.tri_verts.dtype == torch.int32
    assert stats["seeded"] == (name == "seeded_n400")
    assert stats["rounds"] == len(stats["winners"])
    assert sum(stats["winners"]) == n - stats["seed_sites"]
    assert stats["seed_sites"] == (n if stats["seeded"] else 0)  # n < 2048
    if name == "escalation":
        assert stats["escalations"] >= 6 and stats["cavity_cap"] >= 64
    integrity.check_arrays(tri.points_std.numpy(), tri.tri_verts.numpy(), tri.tri_nbrs.numpy(), n_data=n)
    if d == 3:
        assert tri.grid_tri.ndim == 3 and int(tri.grid_tri.min()) >= 0
