"""Port's models/surface.py vs the JAX package, on the CPU.

The alpha shapes of tests/test_surface.py's inputs: the annulus (Qhull
import) and the 400-site native build with equal faces, kept simplexes and
circumradii within 1e-12; the solid ball's watertight reconstruction.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import Delaunay

from gsl_scattered_interpolation_tpu.models import device_delaunay as jdd
from gsl_scattered_interpolation_tpu.models import geometry_extras as jgx
from gsl_scattered_interpolation_tpu.models import host_tree as jht
from gsl_scattered_interpolation_tpu.models import surface as jsurface

from gsl_scattered_interpolation_torch.models import device_delaunay as dd
from gsl_scattered_interpolation_torch.models import geometry_extras as gx
from gsl_scattered_interpolation_torch.models import host_tree, surface
from gsl_scattered_interpolation_torch.utils import errors

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread: the test workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_shape(ours, theirs):
    np.testing.assert_array_equal(ours.faces, theirs.faces)
    np.testing.assert_array_equal(ours.kept, theirs.kept)
    r, jr = ours.circumradius, np.asarray(theirs.circumradius)
    finite = np.isfinite(jr)
    np.testing.assert_array_equal(np.isfinite(r), finite)
    assert np.all(np.abs(r[finite] - jr[finite]) <= 1e-12 * np.maximum(1.0, jr[finite]))


def test_annulus_equals_jax():
    rng = np.random.default_rng(0)
    t = rng.uniform(0, 2 * np.pi, 1500)
    r = rng.uniform(0.6, 1.0, 1500)
    pts = np.stack([r * np.cos(t), r * np.sin(t)], -1)
    sd = Delaunay(pts)
    ours = surface.alpha_shape(gx.from_scipy_delaunay(sd, pts, device=CPU), alpha=0.15)
    _same_shape(ours, jsurface.alpha_shape(jgx.from_scipy_delaunay(sd, pts), alpha=0.15))
    ids, counts = np.unique(ours.faces.ravel(), return_counts=True)
    assert ours.faces.shape[1] == 2 and (counts == 2).all()


def test_native_build_equals_jax():
    pts = np.random.default_rng(1).uniform(-0.5, 0.5, size=(400, 2))
    jtri, _ = jdd.triangulate(pts, flags=jht.NOSTANDARDIZE)
    tri, _ = dd.triangulate(pts, flags=host_tree.NOSTANDARDIZE, device=CPU)
    ours = surface.alpha_shape(tri, alpha=0.2)
    _same_shape(ours, jsurface.alpha_shape(jtri, alpha=0.2))
    assert ours.faces.size > 0 and (ours.faces >= 0).all() and (ours.faces < 400).all()


def test_ball_reconstruction_equals_jax():
    # tests/test_surface.py's solid ball on a jittered 13^3 grid.
    rng = np.random.default_rng(0)
    g = np.linspace(-1, 1, 13)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = pts[np.linalg.norm(pts, axis=1) <= 1.0]
    h = g[1] - g[0]
    pts = pts + rng.uniform(-0.05 * h, 0.05 * h, pts.shape)
    faces, alpha = surface.reconstruct_surface(pts, alpha=1.2 * h, device=CPU)
    jfaces, jalpha = jsurface.reconstruct_surface(pts, alpha=1.2 * h)
    assert alpha == jalpha
    np.testing.assert_array_equal(faces, jfaces)
    assert surface.edge_manifold_check(faces) and jsurface.edge_manifold_check(faces)
    V = np.unique(faces).size
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [0, 2]]], 0)
    E = np.unique(np.sort(e, 1), axis=0).shape[0]
    assert V - E + faces.shape[0] == 2
    # The automatic alpha: 2.5 times the median nearest-neighbour spacing.
    _, a_auto = surface.reconstruct_surface(pts, device=CPU)
    assert a_auto == jsurface.reconstruct_surface(pts)[1]


def test_errors():
    i = np.arange(200) + 0.5
    phi = np.arccos(1 - 2 * i / 200)
    theta = np.pi * (1 + 5**0.5) * i
    pts = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], -1)
    with pytest.raises(errors.DomainError):
        surface.reconstruct_surface(pts, alpha=1e-9, device=CPU)
    with pytest.raises(errors.InvalidArgumentError):
        surface.reconstruct_surface(pts[:, :2], device=CPU)
    open_faces = np.array([[0, 1, 2], [1, 2, 3]])
    assert not surface.edge_manifold_check(open_faces)
