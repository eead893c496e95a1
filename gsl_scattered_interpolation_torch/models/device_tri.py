"""Frozen triangulation on the device: batched point location and evaluation.

The query half of ``gsl_scattered_interpolation_tpu/models/device_tri.py``.
The reference answers a query by a recursive history-DAG descent with a
per-node LU solve (``find_leaf``/``interp_point``, linear_simplex.c:331-402,
678-711).  Here the triangulation is frozen once into flat tensors with
per-triangle affine weight maps, and queries are located in a batch:

* ``points_raw``/``points_std`` [P, d]: cage vertices in rows 0..d, data
  points after them in insertion order, so "is cage" is ``id <= d``;
* ``tri_verts``/``tri_nbrs`` [T, d+1] int32: face k is opposite vertex k,
  -1 is a boundary face;
* ``affine`` [T, d*d + 2d]: ``coords(q) = A (q - anchor) + w_anchor``.

Evaluation dots the weights with the vertex responses; cage rows of the
response are 0, which gives the reference's fade to zero toward the hull
(linear_simplex.c:697-706), and out-of-cage queries give 0.

A triangulation comes from the host engine (:func:`freeze`) or from the
device build (:func:`from_arrays`).  Point location by brute force
(``locate_dense``, and on CUDA the Hopper kernel of ``ops/locate.py`` as
``method="pallas"``) covers up to ``DENSE_LOCATE_MAX_TRIS`` triangles.
The visibility walk and the cell index, which serve larger triangulations,
come with ROADMAP Queue A item 5.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from ..ops import locate as locate_ops
from ..utils import machine

# Brute-force locate covers triangulations up to this size.  The value is
# the JAX package's TPU crossover (device_tri.py:1796-1800), kept as is; the
# H100 crossover against the walk is not measured yet.
DENSE_LOCATE_MAX_TRIS = 16384
PALLAS_LOCATE_MAX_TRIS = 16384

_LATER = "comes with ROADMAP Queue A item 5 (at-scale 2D query)"


@dataclasses.dataclass(frozen=True)
class DeviceTriangulation:
    """Flat triangulation tensors (see the module docstring for the layout).

    Raw and standardized coordinates are both kept: weights are formed from
    ``scale*(a_raw - b_raw)`` (subtract, then scale) for cage-safe
    precision, while the standardized copy serves the bucket grid.
    """

    points_raw: torch.Tensor  # [P, d] float; rows 0..d are cage vertices
    points_std: torch.Tensor  # [P, d] float, scale*(raw - shift)
    tri_verts: torch.Tensor   # [T, d+1] int32
    tri_nbrs: torch.Tensor    # [T, d+1] int32, -1 = boundary face
    # [A (d*d) | anchor (d) | w_anchor (d)]; the anchor is the vertex closest
    # to the data centre and w_anchor its one-hot weights, so float32 scores
    # stay accurate on the huge cage slivers.  Degenerate triangles get
    # w_anchor = -1e30 and never contain a query.
    affine: torch.Tensor      # [T, d*d + 2*d]
    shift: torch.Tensor       # [d]
    scale: torch.Tensor       # [d]
    grid_tri: torch.Tensor    # [G]*d int32: a triangle near each grid cell
    grid_res: int

    @property
    def dim(self) -> int:
        return self.points_std.shape[-1]

    @property
    def n_tris(self) -> int:
        return self.tri_verts.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.points_raw.dtype

    @property
    def device(self) -> torch.device:
        return self.points_raw.device

    @functools.cached_property
    def locate_tables(self):
        """(centre, g_pack, b_pack) of the 2D locate kernel, packed once per
        triangulation (:func:`ops.locate.pack_tables`)."""
        return locate_ops.pack_tables(self)

    def cast(self, dtype) -> "DeviceTriangulation":
        """Cast the float fields (e.g. to float32 for the GPU fast path)."""
        return dataclasses.replace(
            self,
            points_raw=self.points_raw.to(dtype),
            points_std=self.points_std.to(dtype),
            affine=self.affine.to(dtype),
            shift=self.shift.to(dtype),
            scale=self.scale.to(dtype),
        )

    def to(self, device) -> "DeviceTriangulation":
        """Move every tensor to ``device``."""
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if f.name != "grid_res"
            },
        )


def _inv(M):
    """Batched inverse; closed-form adjugate for d <= 3, else a solve.
    Singular matrices give non-finite entries (the caller poisons them)."""
    d = M.shape[-1]
    if d == 1:
        return 1.0 / M
    if d == 2:
        a, b = M[..., 0, 0], M[..., 0, 1]
        c, dd = M[..., 1, 0], M[..., 1, 1]
        det = a * dd - b * c
        adj = torch.stack(
            [torch.stack([dd, -b], -1), torch.stack([-c, a], -1)], -2
        )
        return adj / torch.where(det == 0, torch.nan, det)[..., None, None]
    if d == 3:
        a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        e, f, g = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
        h, i, j = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
        A = f * j - g * i
        B = -(e * j - g * h)
        C = e * i - f * h
        det = a * A + b * B + c * C
        adj = torch.stack(
            [
                torch.stack([A, -(b * j - c * i), b * g - c * f], -1),
                torch.stack([B, a * j - c * h, -(a * g - c * e)], -1),
                torch.stack([C, -(a * i - b * h), a * f - b * e], -1),
            ],
            -2,
        )
        return adj / torch.where(det == 0, torch.nan, det)[..., None, None]
    eye = torch.eye(d, dtype=M.dtype, device=M.device).expand(M.shape)
    out, info = torch.linalg.solve_ex(M, eye)
    return torch.where((info == 0)[..., None, None], out, torch.nan)


def affine_maps(points_raw, tri_verts, scale, shift=None):
    """Per-triangle affine barycentric maps, [T, d*d+2d].

    coords = M^{-1} S (q - v_d) with M the scaled-edge matrix and
    S = diag(scale), rewritten around the vertex closest to ``shift`` as
    ``coords(q) = A (q - anchor) + w_anchor`` with A = M^{-1} S.
    """
    verts = points_raw[tri_verts.long()]  # [T, d+1, d]
    d = verts.shape[-1]
    origin = verts[:, d, :]
    M = ((verts[:, :d, :] - origin[:, None, :]) * scale).transpose(-1, -2)
    A = _inv(M) * scale  # right-multiply by diag(scale)
    ok = torch.isfinite(A).all(dim=-1).all(dim=-1)
    A = torch.where(ok[:, None, None], A, 0.0)
    center = shift if shift is not None else torch.zeros_like(verts[0, 0])
    mag = torch.sum((verts - center) ** 2, dim=-1)  # [T, d+1]
    j = torch.argmin(mag, dim=-1)  # [T]
    anchor = verts[torch.arange(verts.shape[0], device=verts.device), j]
    w_anchor = (
        j[:, None] == torch.arange(d, device=verts.device)[None, :]
    ).to(verts.dtype)
    w_anchor = torch.where(ok[:, None], w_anchor, -1e30)
    return torch.cat([A.reshape(A.shape[0], d * d), anchor, w_anchor], dim=-1)


def _bucket_grid(points_std, tri_verts, grid_res: int) -> np.ndarray:
    """Map each cell of the standardized data square to a nearby simplex.

    Cells take the simplex whose centroid falls in them; empty cells are
    filled from the nearest seeded cell by dilation (host numpy, once).
    """
    centroids = points_std[tri_verts].mean(axis=1)  # [T, d]
    g = np.full((grid_res,) * centroids.shape[1], -1, dtype=np.int32)
    cells = np.clip(
        ((centroids + 0.5) * grid_res).astype(np.int64), 0, grid_res - 1
    )
    g[tuple(cells.T)] = np.arange(centroids.shape[0], dtype=np.int32)
    while (g < 0).any():
        newg = g.copy()
        for ax in range(g.ndim):
            for shift in (1, -1):
                cand = np.roll(g, shift, axis=ax)
                sl = [slice(None)] * g.ndim
                sl[ax] = 0 if shift == 1 else -1
                cand[tuple(sl)] = -1  # roll wraps; suppress the wrapped edge
                newg = np.where(newg < 0, cand, newg)
        if (newg == g).all():
            newg[newg < 0] = 0  # no seeded cell at all (degenerate)
        g = newg
    return g


def _grid_res_3d(n_slots: int, grid_res: int) -> int:
    """Cap the 3D walk-start grid: about one simplex per cell, <= 128^3."""
    auto = int(np.clip(round(n_slots ** (1.0 / 3.0)), 8, 128))
    return min(grid_res, auto) if grid_res > 1 else auto


def freeze(tree, grid_res: int = 64, device="cuda") -> DeviceTriangulation:
    """Export a host SimplexTree's leaves as float64 tensors on ``device``.

    Point ids are remapped: seed -(k+1) -> k, data id i -> d+1+i (insertion
    order).  :func:`reindex_response` maps a user response vector to this
    layout.
    """
    d = tree.dim
    leaves = tree.leaves()
    leaf_of = {node: i for i, node in enumerate(leaves)}

    def pid_map(p):
        return -p - 1 if p < 0 else d + 1 + p

    P = d + 1 + tree.n_points
    raw = np.zeros((P, d))
    raw[: d + 1] = tree.seed_points
    for i in range(tree.n_points):
        raw[d + 1 + i] = tree.point_coords(i)
    pts = tree.scale * (raw - tree.shift)

    T = len(leaves)
    tv = np.zeros((T, d + 1), dtype=np.int32)
    tn = np.full((T, d + 1), -1, dtype=np.int32)
    for i, node in enumerate(leaves):
        tv[i] = [pid_map(int(p)) for p in tree.tri_points[node]]
        for k in range(d + 1):
            nbr = int(tree.tri_links[node, k])
            if nbr != 0:
                tn[i, k] = leaf_of[nbr]

    if d == 2:
        grid = _bucket_grid(pts, tv, grid_res)
    elif d == 3:
        grid_res = _grid_res_3d(T, grid_res)
        grid = _bucket_grid(pts, tv, grid_res)
    else:
        grid = np.zeros((1,) * d, dtype=np.int32)
        grid_res = 1

    def dev(a):
        return torch.as_tensor(a, device=device)

    raw_t, tv_t = dev(raw), dev(tv)
    shift, scale = dev(np.asarray(tree.shift)), dev(np.asarray(tree.scale))
    return DeviceTriangulation(
        points_raw=raw_t,
        points_std=dev(pts),
        tri_verts=tv_t,
        tri_nbrs=dev(tn),
        affine=affine_maps(raw_t, tv_t, scale, shift=shift),
        shift=shift,
        scale=scale,
        grid_tri=dev(grid),
        grid_res=grid_res,
    )


def from_arrays(
    points_raw,
    shift,
    scale,
    tri_v,
    tri_n,
    alive,
    grid_res: int = 256,
    device="cuda",
) -> DeviceTriangulation:
    """Assemble a float64 DeviceTriangulation on ``device`` from build arrays.

    Compacts to the alive simplexes in slot order and remaps neighbour ids,
    on the arrays' device; computes the affine maps in float64 (``cast``
    rounds them, as after :func:`freeze`).  ``points_raw`` rows 0..d are the
    cage.  The walk-start grid comes from the host :func:`_bucket_grid`.
    """
    points_raw = np.asarray(points_raw, np.float64)
    shift = np.asarray(shift, np.float64)
    scale = np.asarray(scale, np.float64)
    d = points_raw.shape[1]
    tri_v = torch.as_tensor(tri_v, device=device)
    tri_n = torch.as_tensor(tri_n, device=device)
    alive = torch.as_tensor(alive, device=device)
    M = tri_v.shape[0]
    keep = torch.nonzero(alive)[:, 0]
    remap = torch.full((M + 1,), -1, dtype=torch.int32, device=tri_v.device)
    remap[keep] = torch.arange(
        keep.numel(), dtype=torch.int32, device=tri_v.device
    )
    tv = tri_v[keep].to(torch.int32)
    tn_keep = tri_n[keep]
    tn = remap[torch.where(tn_keep >= 0, tn_keep, M).long()]

    pts_std = scale * (points_raw - shift)
    if d == 2:
        grid = _bucket_grid(pts_std, tv.cpu().numpy(), grid_res)
    elif d == 3:
        grid_res = _grid_res_3d(tv.shape[0], grid_res)
        grid = _bucket_grid(pts_std, tv.cpu().numpy(), grid_res)
    else:
        grid = np.zeros((1,) * d, dtype=np.int32)
        grid_res = 1

    def dev(a):
        return torch.as_tensor(a, device=tri_v.device)

    raw_t, shift_t, scale_t = dev(points_raw), dev(shift), dev(scale)
    return DeviceTriangulation(
        points_raw=raw_t,
        points_std=dev(pts_std),
        tri_verts=tv,
        tri_nbrs=tn,
        affine=affine_maps(raw_t, tv, scale_t, shift=shift_t),
        shift=shift_t,
        scale=scale_t,
        grid_tri=dev(grid),
        grid_res=grid_res,
    )


def response_for_build(shuffle, response, d: int = 2, device="cuda"):
    """Float64 response [d+1+n] of a device-built triangulation: the cage
    rows are 0 and data row i holds user row ``shuffle[i]``."""
    response = np.asarray(response, np.float64)
    out = np.zeros(d + 1 + response.shape[0], dtype=response.dtype)
    out[d + 1 :] = response[np.asarray(shuffle)]
    return torch.as_tensor(out, device=device)


def reindex_response(tree, response, device="cuda") -> torch.Tensor:
    """User response vector -> float64 device layout [P], cage rows zero.

    Applies the insertion shuffle (linear_simplex.c:699-707): device data
    row i is user row ``shuffle[i]``.
    """
    d = tree.dim
    response = np.asarray(response, dtype=np.float64)
    out = np.zeros(d + 1 + tree.n_points, dtype=response.dtype)
    out[d + 1 :] = response[tree.shuffle[: tree.n_points]]
    return torch.as_tensor(out, device=device)


# ---------------------------------------------------------------------------
# Point location
# ---------------------------------------------------------------------------


def _weights(tri: DeviceTriangulation, cur, q_raw):
    """Full d+1 barycentric weights [B, d+1] via the affine maps."""
    d = tri.dim
    row = tri.affine[cur]  # [B, d*d+2d]
    anchor = row[..., d * d : d * d + d]
    w0 = row[..., d * d + d :]
    A = row[..., : d * d].reshape(*row.shape[:-1], d, d)
    coords = torch.sum(A * (q_raw - anchor)[..., None, :], dim=-1) + w0
    return torch.cat(
        [coords, 1.0 - torch.sum(coords, dim=-1, keepdim=True)], dim=-1
    )


def _in_domain(w):
    # Weights carry ~eps*kappa noise, so sqrt(eps) accepts every query that
    # was located correctly up to a condition number of ~1/sqrt(eps).
    tol = 4.0 * machine.sqrt_eps(w.dtype)
    return torch.all(w >= -tol, dim=-1)


@contextlib.contextmanager
def _full_f32_matmul():
    """Run float32 matmuls in full float32: no TF32 on the GPU.

    The counterpart of the JAX package's ``precision=HIGHEST``: a TF32
    product keeps ~3 decimal digits and would scramble the argmax.
    """
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def locate_dense(tri: DeviceTriangulation, q_raw, block: int | None = None):
    """Brute-force point location: score all simplexes for each query.

    All T*d weights come from one matmul ``[B, d] @ [d, T*d]`` plus a bias.
    The chosen simplex is the one whose smallest weight is largest, which
    falls back to the reference's best-worst-violation rule
    (linear_simplex.c:363-400) when noise leaves no simplex strictly
    containing the query.

    Returns (leaf [B] int64, weights [B, d+1], in_domain [B]).
    """
    d = tri.dim
    T = tri.n_tris
    if block is None:
        # Keep the [block, T*d] score intermediate near 1 GiB.
        block = max(512, min(65536, (1 << 28) // max(T * d, 1)))
    A = tri.affine[:, : d * d].reshape(T, d, d)
    anchor = tri.affine[:, d * d : d * d + d]
    w0 = tri.affine[:, d * d + d :]
    # Centre the queries at the data centre so the operands stay of the
    # order of the data range:
    #   W = (q - c0) . A[t].T + (w0[t] + A[t] @ (c0 - anchor[t]))
    c0 = tri.shift
    G2 = A.transpose(-1, -2).permute(1, 0, 2).reshape(d, T * d)
    bias = (w0 + torch.sum(A * (c0 - anchor)[:, None, :], dim=-1)).reshape(
        T * d
    )
    B = q_raw.shape[0]
    best = torch.empty(B, dtype=torch.int64, device=q_raw.device)
    with _full_f32_matmul():
        for s in range(0, B, block):
            qb = q_raw[s : s + block]
            Wc = (torch.matmul(qb - c0, G2) + bias).reshape(-1, T, d)
            Wlast = 1.0 - torch.sum(Wc, dim=-1)
            minw = torch.minimum(torch.amin(Wc, dim=-1), Wlast)  # [b, T]
            best[s : s + block] = torch.argmax(minw, dim=-1)
    w = _weights(tri, best, q_raw)
    return best, w, _in_domain(w)


def locate(tri, q_raw):
    """Batched visibility walk — not ported yet."""
    raise NotImplementedError(f"the visibility walk {_LATER}")


# ---------------------------------------------------------------------------
# Batched evaluation
# ---------------------------------------------------------------------------


def vertex_responses(tri: DeviceTriangulation, response_ext) -> torch.Tensor:
    """Per-triangle response triplets [T, d+1].

    Pass the result to :func:`interp` as ``resp_tri``: evaluation then does
    one [B, d+1] row gather instead of two chained gathers.
    """
    return response_ext[tri.tri_verts]


def interp(
    tri: DeviceTriangulation,
    response_ext,
    q_raw,
    method: str = "auto",
    resp_tri=None,
):
    """Barycentric interpolation at raw query points [B, d], batched.

    The device analog of find_leaf + interp_point (linear_simplex.c:331-402,
    678-711): cage rows of the response are zero (see
    :func:`reindex_response`), and out-of-cage queries return 0.

    method: "auto" picks the Hopper locate kernel for 2D CUDA queries up to
    ``PALLAS_LOCATE_MAX_TRIS`` triangles, else the matmul brute force
    (:func:`locate_dense`) up to ``DENSE_LOCATE_MAX_TRIS``, else the walk.
    "pallas" forces the locate kernel (its plain version on the CPU),
    "dense" the matmul brute force; "cells" and "walk" are not ported yet.
    """
    if method == "auto":
        if (
            q_raw.device.type == "cuda"
            and tri.dim == 2
            and tri.n_tris <= PALLAS_LOCATE_MAX_TRIS
        ):
            method = "pallas"
        elif tri.n_tris <= DENSE_LOCATE_MAX_TRIS:
            method = "dense"
        else:
            method = "walk"
    if method == "pallas":
        leaf = locate_ops.locate_dense_kernel(tri, q_raw)
        w = _weights(tri, leaf, q_raw)
        in_domain = _in_domain(w)
    elif method == "dense":
        leaf, w, in_domain = locate_dense(tri, q_raw)
    elif method == "cells":
        raise NotImplementedError(f"the cell index {_LATER}")
    else:
        leaf, w, in_domain = locate(tri, q_raw)
    if resp_tri is not None:
        vals = resp_tri[leaf]  # [B, d+1]: one row gather
    else:
        vals = response_ext[tri.tri_verts[leaf]]
    out = torch.sum(w * vals, dim=-1)
    return torch.where(in_domain, out, 0.0)
