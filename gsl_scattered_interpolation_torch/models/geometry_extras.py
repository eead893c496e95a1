"""Convex hull, Voronoi diagram, and the import of Qhull triangulations.

The counterpart of ``gsl_scattered_interpolation_tpu/models/geometry_extras.py``:
features the reference plans but never built (README:18-27).  On the flat
triangulation tensors they are nearly free:

* the convex hull of the sites is the boundary between all-data simplexes
  and simplexes that touch the cage;
* the Voronoi vertices are the circumcentres of the all-data simplexes
  (computed on the triangulation's device), with the Delaunay adjacency as
  the Voronoi edge graph;
* a triangulation built elsewhere (scipy.spatial.Delaunay, i.e. Qhull)
  becomes a DeviceTriangulation through ``device_tri.from_arrays``, with a
  cage that no simplex uses.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import geometry
from . import device_tri


def _data_mask(tv: np.ndarray, d: int) -> np.ndarray:
    return (tv > d).all(axis=1)


def convex_hull_edges(tri: device_tri.DeviceTriangulation) -> np.ndarray:
    """Hull facets as [E, d] arrays of data point ids (0-based data rows of
    the triangulation, in its insertion order).

    A face of an all-data simplex lies on the convex hull iff its neighbour
    across that face touches the cage (or there is none).
    """
    d = tri.dim
    tv = tri.tri_verts.cpu().numpy()
    tn = tri.tri_nbrs.cpu().numpy()
    is_data = _data_mask(tv, d)
    edges = []
    for k in range(d + 1):
        nbr = tn[:, k]
        nbr_cage = ~is_data[np.where(nbr >= 0, nbr, 0)] | (nbr < 0)
        on_hull = is_data & nbr_cage
        edges.append(np.delete(tv, k, axis=1)[on_hull] - (d + 1))
    return np.concatenate(edges, axis=0)


def convex_hull_points(tri: device_tri.DeviceTriangulation) -> np.ndarray:
    """Sorted unique data point ids on the convex hull."""
    return np.unique(convex_hull_edges(tri).ravel())


def voronoi(tri: device_tri.DeviceTriangulation):
    """Voronoi diagram of the data sites by Delaunay duality.

    Returns (vertices [T, d], the standardized circumcentres of the
    all-data simplexes, as numpy; ridges [R, 2], index pairs into
    ``vertices`` for each pair of adjacent all-data simplexes).  Cells on
    the hull are unbounded; their rays are left out (the hull edges close
    them).
    """
    d = tri.dim
    tv = tri.tri_verts.cpu().numpy()
    tn = tri.tri_nbrs.cpu().numpy()
    idx = np.nonzero(_data_mask(tv, d))[0]
    remap = np.full(tv.shape[0], -1, np.int64)
    remap[idx] = np.arange(idx.size)
    rows = torch.as_tensor(idx, device=tri.device)
    centers, _, _ = geometry.circumsphere(tri.points_std[tri.tri_verts[rows].long()])
    ridges = []
    for k in range(d + 1):
        nbr = tn[idx, k]
        good = (nbr >= 0) & (remap[np.where(nbr >= 0, nbr, 0)] >= 0)
        a = remap[idx[good]]
        b = remap[nbr[good]]
        keep = a < b  # each ridge once
        ridges.append(np.stack([a[keep], b[keep]], -1))
    return centers.cpu().numpy(), np.concatenate(ridges, axis=0)


def from_scipy_delaunay(sd, sites, grid_res: int = 256, device="cuda"):
    """A float64 DeviceTriangulation on ``device`` from a
    scipy.spatial.Delaunay (Qhull) triangulation of ``sites`` [n, d].

    The external simplexes are the all-data part; the cage is added as
    vertices that no simplex uses, so a query beyond the hull is out of the
    domain (0) rather than fading, the conservative choice for an imported
    mesh.  The response of data row i is site i:
    ``device_tri.response_for_build(np.arange(n), values, d=d)``.
    """
    sites = np.asarray(sites, np.float64)
    n, d = sites.shape
    lo, hi = sites.min(0), sites.max(0)
    shift = (lo + hi) / 2.0
    ext = hi - lo
    scale = np.where(ext > 0, 1.0 / np.where(ext > 0, ext, 1), 1.0)
    cage = geometry.cage_vertices(d, shift, scale)
    points_raw = np.concatenate([cage, sites])
    tv = np.asarray(sd.simplices, np.int32) + (d + 1)
    tn = np.asarray(sd.neighbors, np.int32)
    tn = np.where(tn >= 0, tn, -1).astype(np.int32)
    # scipy's convention is ours: neighbors[i, k] is opposite vertex k.
    alive = np.ones(tv.shape[0], bool)
    return device_tri.from_arrays(
        points_raw, shift, scale, tv, tn, alive, grid_res=grid_res, device=device
    )
