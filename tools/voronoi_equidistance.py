"""The Voronoi centres of chip_smoke.py's geometry_200k, by both packages'
circumsphere, on the CPU.

chip_smoke.py builds the 200,000 sites of ``default_rng(3)`` in the unit
square with ``NOSTANDARDIZE`` (standardized = raw coordinates) and holds
each Voronoi centre equidistant from its three sites.  The Delaunay
triangulation of points in general position is unique, so scipy's gives the
same all-data triangles as the device build.  This script solves their
circumcentres with the JAX package's ``geometry.circumsphere`` and the
port's (both in absolute coordinates, the reference's formulation) and
with the same system written relative to each triangle's first vertex,
and prints for each the worst relative equidistance, the count over 1e-9,
and, for the worst triangles, the error against the exact centre
(rational arithmetic).  It reads the gate's rounding bound
eps * cond(A) * max|v|^2 / R^2 too:

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 tools/voronoi_equidistance.py
"""

from fractions import Fraction

import jax
import numpy as np
import torch
from scipy.spatial import Delaunay

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from gsl_scattered_interpolation_torch.ops import geometry as tgeom  # noqa: E402
from gsl_scattered_interpolation_tpu.ops import geometry as jgeom  # noqa: E402

N, SEED = 200_000, 3


def equidistance(pts, centers):
    dist = np.linalg.norm(pts - centers[:, None, :], axis=-1)
    return (dist.max(1) - dist.min(1)) / dist.max(1), dist.max(1)


def exact_center(p):
    """The circumcentre of one triangle in rational arithmetic."""
    (ax, ay), (bx, by), (cx, cy) = ([Fraction(float(v)) for v in row] for row in p)
    d = 2 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by))
    a2, b2, c2 = ax * ax + ay * ay, bx * bx + by * by, cx * cx + cy * cy
    ux = (a2 * (by - cy) + b2 * (cy - ay) + c2 * (ay - by)) / d
    uy = (a2 * (cx - bx) + b2 * (ax - cx) + c2 * (bx - ax)) / d
    return np.array([float(ux), float(uy)])


def main():
    sites = np.random.default_rng(SEED).uniform(-0.5, 0.5, size=(N, 2))
    pts = sites[Delaunay(sites).simplices]
    print(f"{N} sites, {pts.shape[0]} triangles")
    origin = pts[:, :1, :]
    rel_c, _, _ = tgeom.circumsphere(torch.from_numpy(pts - origin))
    centers = {
        "jax": np.asarray(jgeom.circumsphere(jnp.asarray(pts))[0]),
        "port": tgeom.circumsphere(torch.from_numpy(pts))[0].numpy(),
        "vertex_relative": rel_c.numpy() + origin[:, 0, :],
    }
    rels = {}
    for name, c in centers.items():
        rel, radius = equidistance(pts, c)
        rels[name] = rel
        print(f"{name}: worst equidistance {rel.max():.6e}, over 1e-9: {(rel > 1e-9).sum()}")
    print(f"jax - port: max |centre difference| {np.abs(centers['jax'] - centers['port']).max():.3e}")
    kappa = np.linalg.cond(pts[:, :2, :] - pts[:, 1:, :])
    bound = np.maximum(1e-9, 4 * np.finfo(np.float64).eps * kappa
                       * (pts ** 2).sum(-1).max(1) / radius ** 2)
    print(f"gate bound: largest {bound.max():.3e}, jax's reading over it "
          f"{(rels['jax'] / bound).max():.3f}")
    for i in np.argsort(rels["jax"])[::-1][:5]:
        ex = exact_center(pts[i])
        r = np.linalg.norm(pts[i][0] - ex)
        errs = ", ".join(f"{k} {np.abs(c[i] - ex).max() / r:.2e}" for k, c in centers.items())
        print(f"triangle {i}: R {r:.3e}, cond {kappa[i]:.1f}, error / R: {errs}")


if __name__ == "__main__":
    main()
