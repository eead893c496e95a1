"""Surface reconstruction: alpha shapes from Delaunay (README:30).

The counterpart of ``gsl_scattered_interpolation_tpu/models/surface.py``.
The alpha shape of a point set is a subcomplex of its Delaunay
triangulation: keep every all-data simplex whose circumradius is at most
``alpha``; the reconstructed surface is the boundary of the kept union
(faces of exactly one kept simplex).  The circumradii come from the
batched circumsphere solve (``ops.geometry.circumsphere``) in float64 on
the triangulation's device; the boundary faces are a sorted-face count on
the host, as in the JAX package.

* 2D: boundary EDGES, the concave hull ("shape") of the sample.
* 3D: boundary TRIANGLES, a watertight surface mesh when alpha matches the
  sampling density.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import geometry
from ..utils import errors
from . import device_tri


class AlphaShape(NamedTuple):
    faces: np.ndarray         # [F, d] data point ids per boundary face
    kept: np.ndarray          # [K] kept simplex rows (into tri.tri_verts)
    circumradius: np.ndarray  # [T] raw-coordinate circumradius per simplex


def alpha_shape(tri: device_tri.DeviceTriangulation, alpha: float) -> AlphaShape:
    """Alpha-shape boundary of the data sites of a triangulation.

    Args:
      tri: a DeviceTriangulation (native build or imported); only all-data
        simplexes take part (cage simplexes are never kept).
      alpha: circumradius threshold in RAW coordinate units.

    Returns faces as data point ids (0-based data rows of ``tri``).
    """
    d = tri.dim
    tv = tri.tri_verts.cpu().numpy()
    is_data = np.all(tv > d, axis=1)
    verts_raw = tri.points_raw.to(torch.float64)[tri.tri_verts.long()]
    _, r2, ok = geometry.circumsphere(verts_raw)
    r = np.sqrt(np.maximum(r2.cpu().numpy(), 0.0))
    keep = is_data & ok.cpu().numpy() & (r <= alpha)
    kept_rows = np.nonzero(keep)[0]
    if kept_rows.size == 0:
        raise errors.DomainError(
            f"alpha={alpha} keeps no simplex (min data circumradius "
            f"{r[is_data].min() if is_data.any() else np.inf:.3g})"
        )
    # Boundary faces: those of exactly one kept simplex.
    faces = [np.sort(np.delete(tv[kept_rows], k, axis=1), axis=1) for k in range(d + 1)]
    uniq, counts = np.unique(np.concatenate(faces, axis=0), axis=0, return_counts=True)
    boundary = uniq[counts == 1] - (d + 1)  # to data ids
    return AlphaShape(faces=boundary, kept=kept_rows, circumradius=r)


def reconstruct_surface(points, alpha: float | None = None, device="cuda"):
    """3D surface mesh from a point sample (alpha-shape reconstruction).

    Triangulates with Qhull (``geometry_extras.from_scipy_delaunay``, on
    ``device``), picks ``alpha`` as 2.5 times the median nearest-neighbour
    spacing when not given, and returns (faces [F, 3] point ids, alpha).
    """
    from scipy.spatial import Delaunay, cKDTree

    from . import geometry_extras

    points = np.asarray(points, np.float64)
    if points.shape[1] != 3:
        raise errors.InvalidArgumentError("reconstruct_surface expects 3D")
    if alpha is None:
        nn, _ = cKDTree(points).query(points, k=2)
        alpha = 2.5 * float(np.median(nn[:, 1]))
    tri = geometry_extras.from_scipy_delaunay(Delaunay(points), points, device=device)
    return alpha_shape(tri, alpha).faces, alpha


def edge_manifold_check(faces: np.ndarray) -> bool:
    """True if every edge of a 3D face set is shared by exactly 2 faces
    (a watertight 2-manifold surface)."""
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [0, 2]]], axis=0
    )
    _, counts = np.unique(np.sort(e, axis=1), axis=0, return_counts=True)
    return bool((counts == 2).all())
