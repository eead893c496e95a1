"""Integrity checks on triangulation arrays, the reference's sanitizer as a
test oracle (``linear_simplex_integrity_check.c``).

The counterpart of the JAX package's ``utils/integrity.py``.  Over a
host ``SimplexTree`` (``models/host_tree.py``):

* :func:`check_structure`: the per-leaf invariants of
  integrity_check.c:62-119: no repeated vertex, not its own neighbour, no
  repeated neighbour, reverse links exist, and the vertex opposite a shared
  face lies in neither simplex.
* :func:`check_delaunay`: the global empty-circumsphere property
  (integrity_check.c:134-168), every point against every leaf's sphere with
  the reference's ``r2 (1 - sqrt(eps))`` tolerance.
* :func:`output_triangulation`: the gnuplot-ready edge, point and circle
  dumps of integrity_check.c:246-284.

Over compacted ``tri_v``/``tri_n`` arrays [T, d+1] (-1 = boundary face) and
standardized points [P, d] (rows 0..d the cage, then the data), vectorized
numpy passes:

* :func:`check_array_structure`: the per-leaf invariants of
  integrity_check.c:62-119, O(T).
* :func:`check_arrays`: those plus the global empty-circumsphere property
  (integrity_check.c:134-168), every data point against every circumsphere.
  That is O(N*T), so it serves test sizes only.
* :func:`local_delaunay_violations`: the empty-circumcircle test across
  every interior edge, O(T), for checks at scale.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import geometry
from . import machine


def check_structure(tree) -> None:
    """Assert per-leaf structural invariants over all current leaves."""
    d = tree.dim
    leaves = tree.leaves()
    leaf_set = set(leaves)
    for node in leaves:
        pts = tree.tri_points[node]
        links = tree.tri_links[node]
        assert len(set(pts.tolist())) == d + 1, f"repeated vertex in {node}"
        nz = [l for l in links if l != 0]
        assert node not in nz, f"{node} is its own neighbor"
        assert len(nz) == len(set(nz)), f"repeated neighbor in {node}"
        for i in range(d + 1):
            nbr = int(links[i])
            if nbr == 0:
                continue
            assert nbr in leaf_set, f"neighbor {nbr} of {node} is not a leaf"
            # The vertex opposite the shared face is in neither simplex.
            assert pts[i] not in tree.tri_points[nbr], (
                f"face vertex {pts[i]} of {node} also in neighbor {nbr}"
            )
            back = np.where(tree.tri_links[nbr] == node)[0]
            assert back.size == 1, f"no unique reverse link {nbr}->{node}"
            assert tree.tri_points[nbr, back[0]] not in pts, (
                f"far vertex of {nbr} also in {node}"
            )


def check_delaunay(tree, dtype=np.float64) -> None:
    """Assert the global empty-circumsphere property, vectorized.

    Every inserted data point must lie outside (or on, within the
    ``1-sqrt(eps)`` slack of integrity_check.c:155-156) every leaf's
    circumsphere.
    """
    leaves = tree.leaves()
    if tree.n_points == 0:
        return
    d = tree.dim
    # Standardized coords of all point ids used by leaves.
    centers = []
    r2s = []
    for node in leaves:
        c, r2 = tree._circumsphere_pts(tree.tri_points[node])
        if c is None:
            continue  # degenerate simplex: skip, as its sphere is undefined
        centers.append(c)
        r2s.append(r2)
    if not centers:
        return
    centers = np.asarray(centers)  # [L, d]
    r2s = np.asarray(r2s)  # [L]
    pts = np.stack([tree.point_std(i) for i in range(tree.n_points)])  # [N, d]
    d2 = np.sum((pts[:, None, :] - centers[None, :, :]) ** 2, axis=-1)  # [N, L]
    ok = d2 > r2s[None, :] * (1 - machine.sqrt_eps(dtype))
    if not np.all(ok):
        bad = np.argwhere(~ok)
        i, l = bad[0]
        raise AssertionError(
            f"Delaunay violated: point {i} inside circumsphere of leaf "
            f"{leaves[int(l)]} (d2={d2[i, l]:.3e} < r2={r2s[l]:.3e}); "
            f"{bad.shape[0]} violations total"
        )


def check_array_structure(tri_v, tri_n) -> None:
    """Assert: no repeated vertex; neighbours are reciprocal, share the
    face, and do not hold the opposite vertex."""
    tri_v = np.asarray(tri_v)
    tri_n = np.asarray(tri_n)
    T, k = tri_v.shape
    for i in range(k):
        for j in range(i + 1, k):
            assert (tri_v[:, i] != tri_v[:, j]).all(), "repeated vertex"
    ids = np.arange(T)
    for m in range(k):
        n = tri_n[:, m]
        has = n >= 0
        ns = np.where(has, n, 0)
        assert (n[has] != ids[has]).all(), "self neighbor"
        back = (tri_n[ns] == ids[:, None]).sum(axis=1)
        assert (back[has] == 1).all(), "reverse link missing/duplicated"
        # Shared face: my verts minus slot m all appear in the neighbor.
        mine = np.delete(tri_v, m, axis=1)  # [T, d]
        shared = (mine[:, :, None] == tri_v[ns][:, None, :]).any(-1).all(-1)
        assert shared[has].all(), "face vertices not shared with neighbor"
        # My slot-m vertex is NOT in the neighbor.
        in_nbr = (tri_v[:, m][:, None] == tri_v[ns]).any(-1)
        assert (~in_nbr[has]).all(), "opposite vertex leaked into neighbor"


def check_arrays(pts_std, tri_v, tri_n, n_data: int, dtype=np.float64):
    """Structure (:func:`check_array_structure`) plus the global
    empty-circumsphere property with the reference's ``r2 (1 - sqrt(eps))``
    tolerance (integrity_check.c:155)."""
    check_array_structure(tri_v, tri_n)
    tri_v = np.asarray(tri_v)
    pts = np.asarray(pts_std)
    d = tri_v.shape[1] - 1
    center, r2, ok = (
        t.numpy() for t in geometry.circumsphere(torch.as_tensor(pts[tri_v]))
    )
    data = pts[d + 1 : d + 1 + n_data]
    d2 = np.sum(
        (data[:, None, :] - center[None, ok.nonzero()[0], :]) ** 2, axis=-1
    )
    good = d2 > r2[ok][None, :] * (1 - machine.sqrt_eps(dtype))
    if not good.all():
        bad = np.argwhere(~good)
        raise AssertionError(
            f"Delaunay violated on device arrays: {bad.shape[0]} pairs; "
            f"first point {bad[0,0]} vs alive tri #{bad[0,1]}"
        )


def local_delaunay_violations(pts, tri_v, tri_n, dtype=np.float64) -> int:
    """Count interior edges of a 2D triangulation whose far vertex lies
    inside the triangle's circumcircle beyond ``r2 (1 - sqrt(eps(dtype)))``.

    Computed in float64 numpy on ``pts`` [P, 2].  Edges of degenerate
    triangles are not counted.  In 2D, local Delaunay on every interior
    edge implies the global property.
    """
    pts = np.asarray(pts, np.float64)
    tri_v = np.asarray(tri_v)
    tri_n = np.asarray(tri_n)
    v = pts[tri_v]  # [T, 3, 2]
    a = v[:, :2, :] - v[:, 1:, :]
    sq = np.sum(v * v, axis=-1)
    b = 0.5 * (sq[:, :2] - sq[:, 1:])
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    ok = det != 0
    safe = np.where(ok, det, 1.0)
    cx = (b[:, 0] * a[:, 1, 1] - a[:, 0, 1] * b[:, 1]) / safe
    cy = (a[:, 0, 0] * b[:, 1] - b[:, 0] * a[:, 1, 0]) / safe
    r2 = (v[:, 0, 0] - cx) ** 2 + (v[:, 0, 1] - cy) ** 2
    tol = 1 - machine.sqrt_eps(dtype)
    bad = 0
    for m in range(3):
        u = tri_n[:, m]
        has = (u >= 0) & ok
        us = np.where(has, u, 0)
        # The neighbour's vertex that is not on the shared face.
        face = np.delete(tri_v, m, axis=1)  # [T, 2]
        nv = tri_v[us]  # [T, 3]
        on_face = (nv[:, :, None] == face[:, None, :]).any(-1)
        far = nv[np.arange(len(nv)), np.argmin(on_face, axis=1)]
        d2 = (pts[far, 0] - cx) ** 2 + (pts[far, 1] - cy) ** 2
        bad += int(np.sum(has & (d2 <= r2 * tol)))
    return bad


def output_triangulation(
    tree,
    response=None,
    standardize: bool = False,
    lines_path=None,
    points_path=None,
    circles_path=None,
) -> None:
    """Dump gnuplot-ready triangulation files (integrity_check.c:246-284).

    Edges between data vertices (seed/cage vertices skipped), one blank-line
    separated segment pair per edge with the response as third column;
    points in standardized coords; per-leaf circumcircles as x y r rows.
    """
    leaves = tree.leaves()

    def coord(pid):
        if standardize:
            return tree.point_std(pid)
        return tree.point_coords(pid)

    if lines_path:
        with open(lines_path, "w") as f:
            for node in leaves:
                pts = tree.tri_points[node]
                for i in range(tree.dim + 1):
                    for j in range(i + 1, tree.dim + 1):
                        i1, i2 = int(pts[i]), int(pts[j])
                        if i1 < 0 or i2 < 0:
                            continue
                        for pid in (i1, i2):
                            r = (
                                float(response[tree.shuffle[pid]])
                                if response is not None
                                else 0.0
                            )
                            xy = " ".join(f"{v:g}" for v in coord(pid))
                            f.write(f"{xy} {r:g}\n")
                        f.write("\n\n")
    if points_path:
        with open(points_path, "w") as f:
            for i in range(tree.n_points):
                xy = " ".join(f"{v:g}" for v in tree.point_std(i))
                f.write(f"{xy}\n")
    if circles_path:
        with open(circles_path, "w") as f:
            for node in leaves:
                c, r2 = tree._circumsphere_pts(tree.tri_points[node])
                if c is None:
                    continue
                f.write(f"{c[0]:g} {c[1]:g} {np.sqrt(r2):g}\n")
