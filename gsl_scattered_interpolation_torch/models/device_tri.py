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
device build (:func:`from_arrays`).  Queries are located by one of:

* brute force (``locate_dense``, and for float32 on CUDA the Hopper kernel
  of ``ops/locate.py`` as ``method="pallas"``), up to
  ``DENSE_LOCATE_MAX_TRIS`` triangles;
* the cell index (:func:`build_cell_index`, :func:`locate_cells`): per-cell
  candidate lists over a uniform grid, one row gather per query, with the
  walk for the queries the lists cannot settle;
* the batched visibility walk (:func:`locate`) from a bucket-grid start.

The walk, the index build and ``locate_cells`` are plain PyTorch ops on
the tensors' device, as they are plain ``jnp`` ops in the JAX package.
The JAX ``while_loop`` and ``lax.cond`` tiers become Python loops with a
few host reads (recorded in ROADMAP.md).  For 2D float32 queries on the
card, ``locate_cells`` scores with ``kernels/csrc/cells2d.cu`` and walks
with ``kernels/csrc/walk2d.cu`` instead, and ``interp`` has the same two
kernels write each query's value (:func:`interp_cells_on_card`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch

from ..ops import cells as cells_ops
from ..ops import geometry
from ..ops import locate as locate_ops
from ..ops import walk as walk_ops
from ..utils import errors, machine, profiling

# Brute-force locate serves triangulations up to this size, and the cell
# index and the walk larger ones.  The value is the JAX package's TPU
# crossover (device_tri.py:1796-1800), kept as is; chip_smoke.py measures
# the H100 crossover against the cell index.
DENSE_LOCATE_MAX_TRIS = 16384
PALLAS_LOCATE_MAX_TRIS = 16384


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


def _grid_device(points_std, tri_verts, grid_res: int):
    """:func:`_bucket_grid` with tensors on their device, any d.

    Where several centroids fall in one cell, the largest simplex id wins
    (``scatter_reduce`` "amax", deterministic on every device).  numpy's
    assignment and XLA's CPU scatter let the last write win, the same id
    (tests/test_torch_chunked.py holds the grids equal).  The centroid
    sums its vertices in order, as numpy's mean does.
    """
    d = points_std.shape[-1]
    verts = points_std[tri_verts.long()]  # [T, d+1, d]
    c = verts[:, 0]
    for j in range(1, d + 1):
        c = c + verts[:, j]
    cells = torch.clamp(
        ((c / (d + 1) + 0.5) * grid_res).long(), 0, grid_res - 1
    )
    flat = cells[:, 0]
    for j in range(1, d):
        flat = flat * grid_res + cells[:, j]
    T = tri_verts.shape[0]
    g = torch.full((grid_res**d,), -1, dtype=torch.int32, device=c.device)
    g = g.scatter_reduce(
        0, flat, torch.arange(T, dtype=torch.int32, device=c.device), "amax"
    ).reshape((grid_res,) * d)
    while bool((g < 0).any()):  # one host read per dilation round
        ng = g
        for ax in range(d):
            for shift in (1, -1):
                cand = torch.roll(g, shift, dims=ax)
                cand.select(ax, 0 if shift == 1 else grid_res - 1).fill_(-1)
                ng = torch.where(ng < 0, cand, ng)
        g = ng
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
    cage.  The 2D and 3D walk-start grids are built on the arrays' device
    (:func:`_grid_device`, the same grid as the host :func:`_bucket_grid`).
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
    if d in (2, 3):
        if d == 3:
            grid_res = _grid_res_3d(tv.shape[0], grid_res)
        grid = _grid_device(
            torch.as_tensor(pts_std, device=tv.device), tv, grid_res
        )
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


# The walk reads ``done.all()`` back from the device once every this many
# steps, where the JAX ``while_loop`` tests it before every step.  A query
# that is done never moves again, so the extra steps change no result.
WALK_DONE_EVERY = 4


def lockstep_steps(n_max: int, max_steps: int) -> int:
    """The steps :func:`locate`'s loop takes when its slowest query stops
    after ``n_max`` iterations (``max_steps + 1``: never): it tests
    ``done`` every ``WALK_DONE_EVERY`` steps and stops at ``max_steps``."""
    return min(max_steps, WALK_DONE_EVERY * -(-n_max // WALK_DONE_EVERY))


def locate(
    tri: DeviceTriangulation,
    q_raw,
    start=None,
    max_steps: int = 128,
    tol: float | None = None,
):
    """Batched visibility-walk point location.

    Every query starts at ``start`` (default: the bucket-grid hint of
    :func:`walk_start`) and steps across its most-violated face until its
    weights are all >= ``-tol``.  On odd steps a query with two violated
    faces takes the second-most-violated one, which breaks the longer
    cycles a deterministic walk can orbit among float32 slivers.  A query
    stops when it steps back to the simplex it came from (2-cycle: both
    contain it within noise) or walks into a boundary face (outside the
    cage).  ``tol`` defaults to 16 ulps of the query dtype; 0 would be the
    reference's exact test (linear_simplex.c:665-675).

    Returns (leaf [B] int64, weights [B, d+1], in_domain [B]).  A query that
    used up ``max_steps`` is reported out of domain unless its final
    simplex contains it.  Each call adds the queries it walked and the
    lockstep steps it took to ``locate.queries`` and ``locate.steps``, and
    its reads of ``done`` back to the host to ``locate.host_reads``.  The
    call is the span ``device_tri.locate``.
    """
    with profiling.span("device_tri.locate"):
        B = q_raw.shape[0]
        dev = q_raw.device
        if tol is None:
            tol = 16.0 * machine.eps(q_raw.dtype)
        if start is None:
            start = walk_start(tri, q_raw)
        cur = torch.as_tensor(start, device=dev).long()
        prev = torch.full((B,), -1, dtype=torch.int64, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        outside = torch.zeros(B, dtype=torch.bool, device=dev)
        faces = torch.arange(tri.dim + 1, device=dev)
        step = 0
        while step < max_steps:
            if step % WALK_DONE_EVERY == 0:
                locate.host_reads += 1
                if bool(done.all()):
                    break
            w = _weights(tri, cur, q_raw)
            worst = torch.argmin(w, dim=-1)
            if step & 1:
                second = torch.argmin(
                    torch.where(faces == worst[:, None], torch.inf, w),
                    dim=-1,
                )
                two_neg = torch.sum(w < -tol, dim=-1) > 1
                worst = torch.where(two_neg, second, worst)
            inside = torch.all(w >= -tol, dim=-1)
            nbr = tri.tri_nbrs[cur].gather(1, worst[:, None])[:, 0].long()
            hit_boundary = (nbr < 0) & ~inside
            cycling = (nbr == prev) & ~inside
            advance = ~(done | inside | hit_boundary | cycling)
            outside = outside | (hit_boundary & ~done)
            done = ~advance
            prev = torch.where(advance, cur, prev)
            # An advancing nbr is >= 0.
            cur = torch.where(advance, nbr, cur)
            step += 1
        locate.queries += B
        locate.steps += step
        w = _weights(tri, cur, q_raw)
        contained = torch.all(w >= -tol, dim=-1)
        return cur, w, ~outside & (contained | done)


locate.queries = 0
locate.steps = 0
locate.host_reads = 0


def walk_start(tri: DeviceTriangulation, q_raw) -> torch.Tensor:
    """Walk start [B] int64: the bucket-grid simplex of each query's cell
    for d <= 3, simplex 0 otherwise."""
    B = q_raw.shape[0]
    if tri.grid_res <= 1 or tri.dim > 3:
        return torch.zeros(B, dtype=torch.int64, device=q_raw.device)
    q_std = geometry.standardize(q_raw, tri.shift, tri.scale)
    cell = torch.clamp((q_std + 0.5) * tri.grid_res, 0, tri.grid_res - 1)
    return tri.grid_tri[tuple(cell.long().unbind(-1))].long()


# ---------------------------------------------------------------------------
# Cell-candidate point location (the large-T path)
# ---------------------------------------------------------------------------

# build_cell_index(method="auto") builds a CPU triangulation's index by the
# device build from this many 2D (3D) simplexes on (the JAX package's
# thresholds).
DEVICE_INDEX_MIN_TRIS = 200_000
DEVICE_INDEX_MIN_TETS = 32_768
# The 3D index takes the packed layout while its table fits this many bytes,
# else the two-stage layout (the JAX package's default budget, a TPU HBM
# figure; a module constant that tests lower).
CELLS3D_PACKED_BYTES = 1_500_000_000


@dataclasses.dataclass(frozen=True)
class CellIndex:
    """Per-cell candidate tables for point location.

    A uniform G^d grid over the standardized data cube; every cell lists
    the simplexes that intersect it (conservative rasterization).  In 2D
    each candidate is 7 float32 fields: the query-centred score form
    (g00, g01, g10, g11, b0, b1) and the triangle id as a float (exact for
    T < 2^24).  The row is field-major (all K g00s, then all K g01s, ...),
    and empty slots score -inf through a 1e30 bias and id -1.  In 3D the
    packed table is the same with 13 fields (9 g, 3 b, id); past
    ``CELLS3D_PACKED_BYTES`` the two-stage layout holds int32 ids [G^3, K]
    (-1 empty) in ``table`` and the 12 score floats per tetrahedron in
    ``rows`` [T, 12].

    Coverage: a query inside a listed cell whose containing triangle
    intersects that cell always finds it.  Overflowed cells (more than K
    intersecting triangles) and out-of-square queries fall back to the
    walk.

    ``complete`` is True iff every simplex/cell intersection is listed (the
    host build, or a device build with no span-cap or pair-budget drops).
    When it is False, :func:`locate_cells` walks every query that no
    candidate contains: a non-overflow cell's "no candidate contains q" is
    exact only for complete lists.  Caveat: an incomplete index's fast
    path is exact only to the tolerance.  A query whose true simplex was
    span-cap-dropped can be accepted by a listed neighbour within the
    float32 containment slack; across a skinny neighbour the value error is
    then of the order of the slack times the weight gradient.
    """

    table: torch.Tensor     # [G^d, (d*d+d+1) K] float32, or [G^3, K] int32
    overflow: torch.Tensor  # [G^d] bool: candidate list truncated
    hint: torch.Tensor      # [G^d] int32: walk-start simplex per cell
    res: int                # G
    k: int                  # K, candidates per cell
    rows: torch.Tensor | None = None  # [T, 12]: the 3D two-stage layout
    complete: bool = True
    # Device build: dropped simplexes plus spilled pairs, and the pairs the
    # bounding boxes within the span cap emitted (n_bad / n_pairs is the
    # dropped share).
    n_bad: int = 0
    n_pairs: int = 0


def _qcentered_tables(tri: DeviceTriangulation):
    """(g [T, d, d], bias [T, d]) with coords(q) = g @ (q - shift) + bias,
    in the triangulation's dtype."""
    d = tri.dim
    T = tri.n_tris
    A = tri.affine[:, : d * d].reshape(T, d, d)
    anchor = tri.affine[:, d * d : d * d + d]
    w0 = tri.affine[:, d * d + d :]
    bias = w0 + torch.sum(A * (tri.shift - anchor)[:, None, :], dim=-1)
    return A, bias


def _qcentered_host(tri: DeviceTriangulation):
    """Host float64 q-centred score tables (numpy).

    Returns ``(g [T, d, d], bias [T, d])`` with
    ``coords(q_raw) = g @ (q_raw - shift) + bias``, the form of
    :func:`_qcentered_tables`, computed from the standardized vertex
    coordinates in float64.  Degenerate simplexes get ``bias = +1e30``, so
    their smallest weight is hugely negative and they never win the argmax
    (the empty-slot convention of the packed cell table).
    """
    pts = tri.points_std.cpu().numpy().astype(np.float64)
    tv = tri.tri_verts.cpu().numpy()
    scale = tri.scale.cpu().numpy().astype(np.float64)
    d = pts.shape[1]
    verts = pts[tv]                       # [T, d+1, d] standardized
    origin = verts[:, d, :]               # coords are weights of verts[:d]
    M = np.swapaxes(verts[:, :d, :] - origin[:, None, :], -1, -2)
    if d == 2:
        a, b = M[:, 0, 0], M[:, 0, 1]
        c, dd_ = M[:, 1, 0], M[:, 1, 1]
        det = a * dd_ - b * c
        adj = np.stack(
            [np.stack([dd_, -b], -1), np.stack([-c, a], -1)], -2
        )
    elif d == 3:
        a, b, c = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
        e, f, g_ = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
        h, i, j = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2]
        A0 = f * j - g_ * i
        B0 = -(e * j - g_ * h)
        C0 = e * i - f * h
        det = a * A0 + b * B0 + c * C0
        adj = np.stack(
            [
                np.stack([A0, -(b * j - c * i), b * g_ - c * f], -1),
                np.stack([B0, a * j - c * h, -(a * g_ - c * e)], -1),
                np.stack([C0, -(a * i - b * h), a * f - b * e], -1),
            ],
            -2,
        )
    else:
        raise NotImplementedError("q-centered host tables are d<=3")
    bad = det == 0
    g_std = adj / np.where(bad, 1.0, det)[:, None, None]
    # q_std - origin = scale*(q - shift) - origin  =>
    # coords = (g_std * scale) @ (q - shift) - g_std @ origin
    g = g_std * scale[None, None, :]
    bias = -np.einsum("tij,tj->ti", g_std, origin)
    g[bad] = 0.0
    bias[bad] = 1e30
    return g, bias


def auto_index_method(device_type: str, n_tris: int, dim: int = 2) -> str:
    """The build that ``build_cell_index(method="auto")`` takes.

    On CUDA always the device build: the numpy rasterizer would copy the
    triangulation to the host and the table back.  On the CPU the numpy
    rasterizer below ``DEVICE_INDEX_MIN_TRIS`` triangles
    (``DEVICE_INDEX_MIN_TETS`` tetrahedra), which lists every intersection
    (a complete index), and the device build from there.
    """
    thresh = DEVICE_INDEX_MIN_TRIS if dim == 2 else DEVICE_INDEX_MIN_TETS
    if device_type == "cuda" or n_tris >= thresh:
        return "device"
    return "host"


def build_cell_index(
    tri: DeviceTriangulation,
    grid_res: int | None = None,
    K: int = 16,
    method: str = "auto",
) -> CellIndex:
    """Rasterize the simplexes into per-cell candidate lists, once.

    Conservative: every (triangle, cell) intersection is listed.  Triangles
    whose bounding box spans at most 4096 cells take the box's cells that
    pass a half-plane test against the cell centre dilated by half a cell
    diagonal; larger ones (cage slivers) take an exact scanline pass.
    Tetrahedra go to :func:`_build_cell_index_3d`, with K at least 24.

    ``method``: "host" is the numpy rasterizer (always complete); "device"
    builds on the triangulation's device (:func:`_build_cell_index_device`);
    "auto" takes :func:`auto_index_method`.  The result's tensors lie on
    the triangulation's device.
    """
    if tri.dim not in (2, 3):
        raise NotImplementedError("cell index is 2D/3D")
    if method == "auto":
        method = auto_index_method(tri.device.type, tri.n_tris, tri.dim)
    if method == "device":
        return _build_cell_index_device(tri, grid_res, K)
    if method != "host":
        raise errors.InvalidArgumentError(f"unknown index method {method!r}")
    if tri.dim == 3:
        # 3D needs deeper lists: the JAX package measured 13.5 % of cells
        # overflowing at K = 16 and about 4 % at K = 24 on 67k tetrahedra.
        return _build_cell_index_3d(tri, grid_res, max(K, 24))
    pts = tri.points_std.cpu().numpy().astype(np.float64)
    tv = tri.tri_verts.cpu().numpy()
    T = tv.shape[0]
    if grid_res is None:
        grid_res = int(np.clip(int(np.sqrt(max(T, 1) / 2.0)), 16, 2048))
    G = int(grid_res)
    cell_w = 1.0 / G  # std square is [-0.5, 0.5]^2

    verts = pts[tv]  # [T, 3, 2]
    lo = np.clip(np.floor((verts.min(1) + 0.5) * G).astype(np.int32), 0, G - 1)
    hi = np.clip(np.floor((verts.max(1) + 0.5) * G).astype(np.int32), 0, G - 1)
    span = (hi[:, 0] - lo[:, 0] + 1).astype(np.int64) * (
        hi[:, 1] - lo[:, 1] + 1
    )

    pair_cell = []
    pair_tri = []
    half_diag = cell_w * np.sqrt(0.5) + 1e-12

    def _halfplane_keep(tris_ids, CX, CY):
        """Conservative triangle/cell-centre test, vectorized over pairs."""
        a = verts[tris_ids, 0]
        b = verts[tris_ids, 1]
        c = verts[tris_ids, 2]
        area = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (
            b[:, 1] - a[:, 1]
        ) * (c[:, 0] - a[:, 0])
        sgn = np.where(area >= 0, 1.0, -1.0)
        ok = np.ones(tris_ids.shape, bool)
        for p, qv in ((a, b), (b, c), (c, a)):
            ex, ey = qv[:, 0] - p[:, 0], qv[:, 1] - p[:, 1]
            el = np.hypot(ex, ey)
            el = np.where(el == 0, 1.0, el)
            inward = sgn * (ex * (CY - p[:, 1]) - ey * (CX - p[:, 0])) / el
            ok &= inward >= -half_diag
        return ok

    def emit_bbox(mask):
        ids = np.nonzero(mask)[0].astype(np.int32)
        if ids.size == 0:
            return
        nx = (hi[ids, 0] - lo[ids, 0] + 1).astype(np.int64)
        ny = (hi[ids, 1] - lo[ids, 1] + 1).astype(np.int64)
        cnt = nx * ny
        rep = np.repeat(ids, cnt)
        k = np.arange(cnt.sum(), dtype=np.int64) - np.repeat(
            np.cumsum(cnt) - cnt, cnt
        )
        nxr = np.repeat(nx, cnt)
        dx = (k % nxr).astype(np.int32)
        dy = (k // nxr).astype(np.int32)
        cx_i = lo[rep, 0] + dx
        cy_i = lo[rep, 1] + dy
        # Drop the box cells the triangle does not reach.
        CX = (cx_i + 0.5) * cell_w - 0.5
        CY = (cy_i + 0.5) * cell_w - 0.5
        keep = _halfplane_keep(rep, CX, CY)
        pair_tri.append(rep[keep])
        pair_cell.append(
            cx_i[keep].astype(np.int64) * G + cy_i[keep]
        )

    big = span > 4096
    emit_bbox(~big)
    # Scanline pass for the few huge triangles: per x-row, the dilated
    # half-planes give a closed-form y-cell interval, O(G) cells per
    # triangle instead of O(G^2).
    big_ids = np.nonzero(big)[0]
    if big_ids.size:
        bv = verts[big_ids]                      # [B, 3, 2]
        area = (bv[:, 1, 0] - bv[:, 0, 0]) * (bv[:, 2, 1] - bv[:, 0, 1]) - (
            bv[:, 1, 1] - bv[:, 0, 1]
        ) * (bv[:, 2, 0] - bv[:, 0, 0])
        sgn = np.where(area >= 0, 1.0, -1.0)
        p = bv                                   # edge tails
        qv = bv[:, [1, 2, 0], :]                 # edge heads
        ex = qv[..., 0] - p[..., 0]              # [B, 3]
        ey = qv[..., 1] - p[..., 1]
        el = np.hypot(ex, ey)
        el = np.where(el == 0, 1.0, el)
        alpha = sgn[:, None] * ex / el           # inward = alpha*CY - beta'
        rows_per = (hi[big_ids, 0] - lo[big_ids, 0] + 1).astype(np.int64)
        rep = np.repeat(np.arange(big_ids.size), rows_per)
        k = np.arange(rows_per.sum(), dtype=np.int64) - np.repeat(
            np.cumsum(rows_per) - rows_per, rows_per
        )
        xrow = lo[big_ids[rep], 0] + k
        CXr = (xrow + 0.5) * cell_w - 0.5        # [R]
        # constraint per edge: alpha*CY >= beta, from
        # sgn*(ex*(CY-py) - ey*(CX-px))/el >= -half_diag
        beta = (
            -half_diag
            + sgn[rep, None] * ey[rep] * (CXr[:, None] - p[rep, :, 0]) / el[rep]
            + alpha[rep] * p[rep, :, 1]
        )                                        # [R, 3]
        al = alpha[rep]
        with np.errstate(divide="ignore", invalid="ignore"):
            lb = np.where(al > 0, beta / al, -np.inf)
            ub = np.where(al < 0, beta / al, np.inf)
        feas_eq = np.all((al != 0) | (beta <= 0), axis=1)
        ylo = lb.max(axis=1)
        yhi = ub.min(axis=1)
        jlo = np.ceil((ylo + 0.5) / cell_w - 0.5).astype(np.int64)
        jhi = np.floor((yhi + 0.5) / cell_w - 0.5).astype(np.int64)
        jlo = np.maximum(jlo, lo[big_ids[rep], 1])
        jhi = np.minimum(jhi, hi[big_ids[rep], 1])
        width = np.where(feas_eq & (ylo <= yhi), jhi - jlo + 1, 0)
        width = np.maximum(width, 0)
        tot = int(width.sum())
        if tot:
            rep2 = np.repeat(np.arange(width.size), width)
            jj = np.arange(tot, dtype=np.int64) - np.repeat(
                np.cumsum(width) - width, width
            )
            pair_tri.append(big_ids[rep[rep2]])
            pair_cell.append(xrow[rep2] * G + jlo[rep2] + jj)

    cells = np.concatenate(pair_cell)
    tris = np.concatenate(pair_tri)
    order = np.argsort(cells, kind="stable")
    cells = cells[order]
    tris = tris[order]
    counts = np.bincount(cells, minlength=G * G)
    starts = np.concatenate([[0], np.cumsum(counts)])
    rank = (np.arange(cells.size, dtype=np.int64) - starts[cells]).astype(
        np.int32
    )
    keep = rank < K
    overflow = counts > K
    rows_k = cells[keep]
    cols_k = rank[keep]
    tri_k = tris[keep]

    # Walk-start hint: the first listed triangle, else the bucket grid's.
    hint = np.full(G * G, -1, np.int32)
    first = cols_k == 0
    hint[rows_k[first]] = tri_k[first]
    empty = hint < 0
    if empty.any():
        fallback = tri.grid_tri.cpu().numpy().reshape(-1)
        gr = tri.grid_res
        idx = np.arange(G * G)
        gx = (idx // G) * gr // G
        gy = (idx % G) * gr // G
        hint[empty] = fallback[(gx * gr + gy)[empty]]

    # Pack the q-centred rows and the id as float32, field-major.
    gmat, bias = _qcentered_host(tri)
    gmat = gmat.astype(np.float32).reshape(T, 4)
    bias = bias.astype(np.float32)
    packed = np.zeros((G * G, 7, K), np.float32)
    packed[:, 4:6, :] = 1e30
    packed[:, 6, :] = -1.0
    for f in range(4):
        packed[rows_k, f, cols_k] = gmat[tri_k, f]
    packed[rows_k, 4, cols_k] = bias[tri_k, 0]
    packed[rows_k, 5, cols_k] = bias[tri_k, 1]
    packed[rows_k, 6, cols_k] = tri_k.astype(np.float32)

    def dev(a):
        return torch.as_tensor(a, device=tri.device)

    return CellIndex(
        table=dev(packed.reshape(G * G, 7 * K)),
        overflow=dev(overflow),
        hint=dev(hint),
        res=G,
        k=K,
    )


def _build_cell_index_3d(
    tri: DeviceTriangulation, grid_res: int | None = None, K: int = 24
) -> CellIndex:
    """3D cell index on the host: conservative tetrahedron rasterization.

    Each tetrahedron emits the cells of its bounding box that pass an
    exact box/half-space test on all four faces (margin: the support of
    the half-cell box on the face normal), in chunks of at most 8M pairs.
    Cells with more than K candidates are marked overflow, and the walk
    answers their misses.  The packed layout is taken while its table fits
    ``CELLS3D_PACKED_BYTES``, else the two-stage layout (see
    :class:`CellIndex`).
    """
    pts = tri.points_std.cpu().numpy().astype(np.float64)
    tv = tri.tri_verts.cpu().numpy()
    T = tv.shape[0]
    if grid_res is None:
        # G = 1.7 T^(1/3): about 9 candidates per cell on uniform input.
        grid_res = int(np.clip(round(1.7 * max(T, 1) ** (1.0 / 3.0)), 8, 160))
    G = int(grid_res)
    cell_w = 1.0 / G

    verts = pts[tv]  # [T, 4, 3]
    lo = np.clip(np.floor((verts.min(1) + 0.5) * G).astype(np.int64), 0, G - 1)
    hi = np.clip(np.floor((verts.max(1) + 0.5) * G).astype(np.int64), 0, G - 1)
    span = np.prod(hi - lo + 1, axis=1)

    # Unit face normals pointing into the tetrahedron; face k is opposite
    # vertex k.
    normals = np.zeros((T, 4, 3))
    offsets = np.zeros((T, 4))
    for k, (i, j, l) in enumerate(_FACES_3D):
        a, b, c = verts[:, i], verts[:, j], verts[:, l]
        n = np.cross(b - a, c - a)
        ln = np.linalg.norm(n, axis=1)
        n = n / np.where(ln == 0, 1.0, ln)[:, None]
        s = np.sum(n * (verts[:, k] - a), axis=1)
        n = np.where(s[:, None] >= 0, n, -n)
        normals[:, k] = n
        offsets[:, k] = np.sum(n * a, axis=1)

    pair_cell = []
    pair_tri = []

    def emit(ids):
        """(cell, tet) pairs of the given tetrahedra, in chunks."""
        if ids.size == 0:
            return
        nx = hi[ids, 0] - lo[ids, 0] + 1
        ny = hi[ids, 1] - lo[ids, 1] + 1
        nz = hi[ids, 2] - lo[ids, 2] + 1
        cnt = nx * ny * nz
        CH = 8_000_000  # pairs per chunk: bounds the host memory
        starts = np.concatenate([[0], np.cumsum(cnt)])
        pos = 0
        while pos < ids.size:
            end = int(np.searchsorted(starts, starts[pos] + CH, side="left"))
            end = max(end, pos + 1)
            sl = slice(pos, end)
            rep = np.repeat(ids[sl], cnt[sl])
            k = np.arange(rep.size, dtype=np.int64) - np.repeat(
                np.cumsum(cnt[sl]) - cnt[sl], cnt[sl]
            )
            nxr = np.repeat(nx[sl], cnt[sl])
            nyr = np.repeat(ny[sl], cnt[sl])
            cx = lo[rep, 0] + k % nxr
            cy = lo[rep, 1] + (k // nxr) % nyr
            cz = lo[rep, 2] + k // (nxr * nyr)
            C = np.stack(
                [(cx + 0.5) * cell_w - 0.5,
                 (cy + 0.5) * cell_w - 0.5,
                 (cz + 0.5) * cell_w - 0.5], axis=1
            )
            keep = np.ones(rep.size, bool)
            for kf in range(4):
                nrm = normals[rep, kf]
                d_in = np.sum(nrm * C, axis=1) - offsets[rep, kf]
                margin = 0.5 * cell_w * np.abs(nrm).sum(axis=1) + 1e-12
                keep &= d_in >= -margin
            pair_tri.append(rep[keep].astype(np.int64))
            pair_cell.append((cx[keep] * G + cy[keep]) * G + cz[keep])
            pos = end

    emit(np.nonzero(span <= 4096)[0])
    emit(np.nonzero(span > 4096)[0])

    cells_f = np.concatenate(pair_cell) if pair_cell else np.zeros(0, np.int64)
    tris_f = np.concatenate(pair_tri) if pair_tri else np.zeros(0, np.int64)
    order = np.argsort(cells_f, kind="stable")
    cells_f = cells_f[order]
    tris_f = tris_f[order]
    counts = np.bincount(cells_f, minlength=G**3)
    starts = np.concatenate([[0], np.cumsum(counts)])
    rank = (np.arange(cells_f.size, dtype=np.int64) - starts[cells_f]).astype(
        np.int32
    )
    keep = rank < K
    overflow = counts > K
    rows_k = cells_f[keep]
    cols_k = rank[keep]
    tri_k = tris_f[keep]

    # Walk-start hint: the first listed tetrahedron, else the bucket grid's.
    hint = np.full(G**3, -1, np.int32)
    first = cols_k == 0
    hint[rows_k[first]] = tri_k[first].astype(np.int32)
    empty = hint < 0
    if empty.any():
        gr = tri.grid_res
        fallback = tri.grid_tri.cpu().numpy().reshape(-1)
        idx = np.arange(G**3)
        gx = np.minimum((idx // (G * G)) * gr // G, gr - 1)
        gy = np.minimum(((idx // G) % G) * gr // G, gr - 1)
        gz = np.minimum((idx % G) * gr // G, gr - 1)
        hint[empty] = fallback[((gx * gr + gy) * gr + gz)[empty]]

    gmat, bias = _qcentered_host(tri)
    gmat = gmat.astype(np.float32).reshape(T, 9)
    bias = bias.astype(np.float32)

    def dev(a):
        return torch.as_tensor(a, device=tri.device)

    if G**3 * 13 * K * 4 <= CELLS3D_PACKED_BYTES:
        packed = np.zeros((G**3, 13, K), np.float32)
        packed[:, 9:12, :] = 1e30  # empty slots score -inf
        packed[:, 12, :] = -1.0
        for f in range(9):
            packed[rows_k, f, cols_k] = gmat[tri_k, f]
        for f in range(3):
            packed[rows_k, 9 + f, cols_k] = bias[tri_k, f]
        packed[rows_k, 12, cols_k] = tri_k.astype(np.float32)
        return CellIndex(
            table=dev(packed.reshape(G**3, 13 * K)),
            overflow=dev(overflow),
            hint=dev(hint),
            res=G,
            k=K,
        )
    ids = np.full((G**3, K), -1, np.int32)
    ids[rows_k, cols_k] = tri_k.astype(np.int32)
    return CellIndex(
        table=dev(ids),
        overflow=dev(overflow),
        hint=dev(hint),
        res=G,
        k=K,
        rows=dev(np.concatenate([gmat, bias], axis=1)),
    )


# Face k of a tetrahedron is opposite vertex k.
_FACES_3D = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))


def _device_index_statics(T: int, d: int, grid_res, K):
    """(G, K, span_cap, P) of the device index build.

    3D: K at least 24; a tetrahedron whose box spans more than 1,024 cells
    (hull and cage-gap geometry) emits nothing, and the pair budget is 128
    per tetrahedron (the JAX package measured 34 % of pairs dropped at a
    budget of 80 on 67k tetrahedra).
    """
    if d == 2:
        G = (
            int(np.clip(int(np.sqrt(max(T, 1) / 2.0)), 16, 2048))
            if grid_res is None
            else int(grid_res)
        )
        return G, int(K), 64, 8 * T
    G = (
        int(np.clip(round(1.7 * max(T, 1) ** (1.0 / 3.0)), 8, 160))
        if grid_res is None
        else int(grid_res)
    )
    return G, max(int(K), 24), 1024, 128 * T


def _cross(u, v):
    """Cross product of [..., 3] rows, in ``jnp.cross``'s order of operations."""
    return torch.stack(
        [
            u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
            u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
            u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0],
        ],
        -1,
    )


def _face_coefficients(verts, cell_w: float):
    """[T, d+1, d+1] float32 half-space coefficients (a_0..a_{d-1}, c0) per
    edge (2D) or face (3D): a cell centre C may touch the simplex only if
    ``sum_j a_j C_j + c0 >= 0`` on every one.  The normals point inward and
    c0 holds the half cell's support on the normal plus a float32 slack."""
    slack = 32.0 * machine.eps(np.float32)
    coeff = []
    if verts.shape[-1] == 2:
        a, b, c = verts[:, 0], verts[:, 1], verts[:, 2]
        area = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (
            b[:, 1] - a[:, 1]
        ) * (c[:, 0] - a[:, 0])
        sgn = torch.where(area >= 0, 1.0, -1.0).to(verts.dtype)
        for p_, q_ in ((a, b), (b, c), (c, a)):
            ex = q_[:, 0] - p_[:, 0]
            ey = q_[:, 1] - p_[:, 1]
            mag = torch.abs(ex) + torch.abs(ey)
            c0 = (
                -sgn * (ex * p_[:, 1] - ey * p_[:, 0])
                + 0.5 * cell_w * mag
                + slack * mag
            )
            coeff.append(torch.stack([-sgn * ey, sgn * ex, c0], -1))
        return torch.stack(coeff, 1)
    for kf, (i_, j_, l_) in enumerate(_FACES_3D):
        a, b, c = verts[:, i_], verts[:, j_], verts[:, l_]
        n = _cross(b - a, c - a)
        e = verts[:, kf] - a
        s = n[:, 0] * e[:, 0] + n[:, 1] * e[:, 1] + n[:, 2] * e[:, 2]
        n = torch.where(s[:, None] >= 0, n, -n)
        mag = torch.abs(n[:, 0]) + torch.abs(n[:, 1]) + torch.abs(n[:, 2])
        na = n[:, 0] * a[:, 0] + n[:, 1] * a[:, 1] + n[:, 2] * a[:, 2]
        c0 = -na + 0.5 * cell_w * mag + slack * mag
        coeff.append(torch.cat([n, c0[:, None]], -1))
    return torch.stack(coeff, 1)


def _device_index_kernel(
    tri: DeviceTriangulation, G: int, K: int, span_cap: int, P: int,
    packed: bool = True,
):
    """The cell-index build on the triangulation's device (2D and 3D).

      1. bounding-box cell ranges per simplex; a simplex whose box spans
         more than ``span_cap`` cells (a cage sliver) emits nothing and
         makes the index incomplete;
      2. a fixed budget of P (simplex, cell) pairs: exclusive-cumsum
         starts, a scatter-max and a cummax give each pair its simplex,
         division its cell (pairs past the budget make it incomplete);
      3. a conservative filter: keep a pair iff the cell centre lies inside
         every edge's (face's) half-space pushed out by the cell's support
         on the normal plus a float32 slack;
      4. ranking: each cell keeps its K lowest pair ids (the host's
         first-K-by-id order), by one sort;
      5. packing: one row scatter into a row-major table, then one
         transpose to the field-major [G^d, NF K] layout (NF = 7 in 2D, 13
         in 3D); or, with ``packed`` False (3D), the int32 id table.

    Returns ``(table, overflow, hint, counts, rows)``; ``counts`` holds
    ``n_bad``, the dropped simplexes and spilled pairs (0: the index is
    complete), and the emitted pairs, ``rows`` the [T, 12] score rows of
    the two-stage layout (None when packed).  ``mode="drop"`` writes of the JAX build go to a
    trash row that is cut off, and the pair starts are int64.
    """
    d = tri.dim
    dev = tri.device
    T = tri.n_tris
    f32 = torch.float32
    i64 = torch.int64
    cell_w = 1.0 / G
    NC = G**d
    verts = tri.points_std[tri.tri_verts.long()].to(f32)  # [T, d+1, d]
    lo = torch.clamp(torch.floor((verts.amin(1) + 0.5) * G), 0, G - 1).long()
    hi = torch.clamp(torch.floor((verts.amax(1) + 0.5) * G), 0, G - 1).long()
    spans = hi - lo + 1  # [T, d]
    cnt = torch.prod(spans, 1)
    emit = cnt <= span_cap
    cnt_e = torch.where(emit, cnt, 0)
    starts = torch.cumsum(cnt_e, 0) - cnt_e
    total = starts[-1] + cnt_e[-1]
    n_bad = torch.sum(~emit) + torch.clamp(total - P, min=0)
    counts = torch.stack([n_bad, total])

    # 2. pair -> owning simplex: scatter each emitting simplex's id at its
    # start (distinct among emitters) and forward-fill by cummax.  Pairs
    # past the budget decompose to junk cells; a junk pair never contains
    # a query of its cell, and n_bad > 0 makes every miss walk.
    ok_sc = (cnt_e > 0) & (starts < P)
    own = torch.zeros(P + 1, dtype=i64, device=dev).scatter_reduce_(
        0, torch.where(ok_sc, starts, P), torch.arange(T, device=dev), "amax"
    )
    rep = torch.cummax(own[:P], 0).values
    pidx = torch.arange(P, device=dev)
    pvalid = pidx < torch.clamp(total, max=P)
    k_in = pidx - starts[rep]
    lo_p = lo[rep]
    sp_p = spans[rep]
    r = k_in // sp_p[:, 0]
    if d == 2:
        cxy = torch.stack([lo_p[:, 0] + k_in % sp_p[:, 0], lo_p[:, 1] + r], -1)
        cid = cxy[:, 0] * G + cxy[:, 1]
    else:
        cxy = torch.stack(
            [
                lo_p[:, 0] + k_in % sp_p[:, 0],
                lo_p[:, 1] + r % sp_p[:, 1],
                lo_p[:, 2] + r // sp_p[:, 1],
            ],
            -1,
        )
        cid = (cxy[:, 0] * G + cxy[:, 1]) * G + cxy[:, 2]
    del lo_p, sp_p, k_in, r

    # 3. conservative filter, one edge (face) at a time.
    face = _face_coefficients(verts, cell_w)  # [T, d+1, d+1]
    Cc = (cxy.to(f32) + 0.5) * cell_w - 0.5  # [P, d]
    keep = pvalid
    for kf in range(d + 1):
        blk = face[:, kf][rep]  # [P, d+1]
        v = blk[:, d]
        for j in range(d):
            v = v + blk[:, j] * Cc[:, j]
        keep = keep & (v >= 0)
    del Cc, cxy
    cidk = torch.where(keep, cid, NC)

    # 4. ranking -> per-pair column; col < K wins a table slot.
    # Pairs are in simplex-id order, so one sort on the unique key (cell,
    # pair id) puts each cell's run in the host's first-K-by-id order.
    key, order = torch.sort(cidk * P + pidx)
    skey = key // P
    del key, cidk
    newrun = torch.ones(P, dtype=torch.bool, device=dev)
    newrun[1:] = skey[1:] != skey[:-1]
    runstart = torch.cummax(torch.where(newrun, pidx, -1), 0).values
    srank = torch.clamp(pidx - runstart, max=K)
    col = torch.full((P,), K, dtype=i64, device=dev)
    col[order] = torch.where(skey < NC, srank, K)
    del skey, order, runstart, srank, newrun
    got = keep & (col < K)
    overflow = torch.zeros(NC + 1, dtype=torch.bool, device=dev)
    overflow[torch.where(keep & (col >= K), cid, NC)] = True
    rowidx = torch.where(got, cid * K + col, NC * K)

    # 5. score fields and packing.
    A, bias = _qcentered_tables(tri)
    NF = d * d + d + 1
    score = torch.cat(
        [
            A.to(f32).reshape(T, d * d),
            bias.to(f32),
            torch.arange(T, dtype=f32, device=dev)[:, None],
        ],
        -1,
    )  # [T, NF]
    # hint: the col == 0 winner, else the walk-start bucket grid's simplex.
    hint = torch.full((NC + 1,), -1, dtype=torch.int32, device=dev)
    hint[torch.where(got & (col == 0), cid, NC)] = rep.to(torch.int32)
    gr = tri.grid_res
    idx = torch.arange(NC, device=dev)
    if d == 2:
        fb = ((idx // G) * gr // G) * gr + (idx % G) * gr // G
    else:
        gx = torch.clamp((idx // (G * G)) * gr // G, max=gr - 1)
        gy = torch.clamp(((idx // G) % G) * gr // G, max=gr - 1)
        gz = torch.clamp((idx % G) * gr // G, max=gr - 1)
        fb = (gx * gr + gy) * gr + gz
    hint = hint[:NC]
    hint = torch.where(hint >= 0, hint, tri.grid_tri.reshape(-1)[fb])

    if not packed:
        ids = torch.full((NC * K + 1,), -1, dtype=torch.int32, device=dev)
        ids[rowidx] = rep.to(torch.int32)
        rows = score[:, : NF - 1].contiguous()
        return ids[: NC * K].reshape(NC, K), overflow[:NC], hint, counts, rows
    init_row = torch.zeros(NF, dtype=f32, device=dev)
    init_row[d * d : d * d + d] = 1e30
    init_row[NF - 1] = -1.0
    table_rm = init_row.expand(NC * K + 1, NF).clone()
    table_rm[rowidx] = score[rep]
    table = (
        table_rm[: NC * K].reshape(NC, K, NF).transpose(1, 2).reshape(NC, NF * K)
    )
    return table, overflow[:NC], hint, counts, None


def _build_cell_index_device(
    tri: DeviceTriangulation,
    grid_res: int | None = None,
    K: int = 16,
    pair_budget_override: int | None = None,
) -> CellIndex:
    """The cell index built on the triangulation's device
    (:func:`_device_index_kernel`).  A 3D index takes the packed layout
    while it fits ``CELLS3D_PACKED_BYTES``.  Reads two scalars back, the
    drop and pair counts, to set ``complete``, ``n_bad`` and ``n_pairs``.
    ``pair_budget_override`` (pairs per simplex) is a test hook that forces
    budget spills."""
    T = tri.n_tris
    G, K, span_cap, P = _device_index_statics(T, tri.dim, grid_res, K)
    if pair_budget_override is not None:
        P = pair_budget_override * T
    packed = tri.dim == 2 or G**3 * 13 * K * 4 <= CELLS3D_PACKED_BYTES
    table, overflow, hint, counts, rows = _device_index_kernel(
        tri, G, K, span_cap, P, packed
    )
    n_bad, n_pairs = counts.tolist()
    return CellIndex(
        table=table,
        overflow=overflow,
        hint=hint,
        res=G,
        k=K,
        rows=rows,
        complete=n_bad == 0,
        n_bad=n_bad,
        n_pairs=n_pairs,
    )


def _cells_of(tri: DeviceTriangulation, G: int, q_raw):
    """(q_std [B, d], cid [B] int64): the standardized queries and the ids
    of their cells of the G^d grid, clamped into it."""
    q_std = geometry.standardize(q_raw, tri.shift, tri.scale)
    cell = torch.clamp(torch.floor((q_std + 0.5) * G), 0, G - 1).long()
    cid = cell[:, 0]
    for j in range(1, tri.dim):
        cid = cid * G + cell[:, j]
    return q_std, cid


def _settle(
    tri: DeviceTriangulation, cells: CellIndex, q_raw, cid, leaf, bestw, q_std
):
    """(w, in_domain, bad) of the best candidates: the leaves' weights in
    the query dtype, and the queries ``locate_cells`` walks."""
    w = _weights(tri, leaf, q_raw)
    # The float32 score is judged at float32's slack, the weights at the
    # query dtype's.
    score_dtype = (
        cells.table.dtype if cells.rows is None else cells.rows.dtype
    )
    contained = bestw >= -4.0 * machine.sqrt_eps(score_dtype)
    w_ok = torch.all(w >= -4.0 * machine.sqrt_eps(q_raw.dtype), dim=-1)
    outside_sq = torch.any(torch.abs(q_std) > 0.5, dim=-1)
    if cells.complete:
        bad = ((cells.overflow[cid] | outside_sq) & ~contained) | (
            contained & ~w_ok
        )
    else:
        bad = ~(contained & w_ok)
    return w, contained & w_ok, bad


def _locate_cells_score_2d(tri: DeviceTriangulation, cells: CellIndex, q_raw):
    """2D candidate scoring: (leaf [B] int64, weights [B, 3], in_domain [B],
    bad [B]), ``bad`` being the queries :func:`locate_cells` walks.

    One [B, 7K] row gather, sliced field-major, scores every candidate in
    the query dtype; the best is ``torch.argmax``'s.  The plain version of
    ``kernels/csrc/cells2d.cu`` (``ops.cells.cells2d_cuda``), which agrees
    with it to the bit, and the route of float64 queries and of the CPU.
    """
    K = cells.k
    dtype = q_raw.dtype
    q_std, cid = _cells_of(tri, cells.res, q_raw)
    rows = cells.table[cid].to(dtype)  # one [B, 7K] gather
    g00, g01, g10, g11, b0, b1, tid = rows.split(K, dim=1)
    shift = tri.shift.to(dtype)
    qx = (q_raw[:, 0] - shift[0])[:, None]
    qy = (q_raw[:, 1] - shift[1])[:, None]
    c0 = g00 * qx + g01 * qy + b0
    c1 = g10 * qx + g11 * qy + b1
    minw = torch.minimum(torch.minimum(c0, c1), 1.0 - c0 - c1)
    minw = torch.where(tid >= 0, minw, -torch.inf)
    best = torch.argmax(minw, dim=-1, keepdim=True)
    bestw = minw.gather(1, best)[:, 0]
    leaf = torch.clamp(tid.gather(1, best)[:, 0], min=0).long()
    return leaf, *_settle(tri, cells, q_raw, cid, leaf, bestw, q_std)


def _locate_cells_score_3d(tri: DeviceTriangulation, cells: CellIndex, q_raw):
    """3D candidate scoring: (cid, leaf, best min-weight, q_std), [B] each.

    Packed layout: one [B0, 13K] row gather per block of queries, sliced
    field-major as in 2D.  Two-stage layout: a [B0, K] id gather, then a
    [B0 K, 12] gather of the candidates' score rows.  Blocks of 262,144
    (packed) or 65,536 (two-stage) queries bound the gathered rows' memory
    to about 330 and 200 MB (JAX: ``lax.map`` over 262,144 and 8,192, sized
    for the TPU's lane padding).
    """
    K = cells.k
    dtype = q_raw.dtype
    B = q_raw.shape[0]
    q_std, cid = _cells_of(tri, cells.res, q_raw)
    dq = q_raw - tri.shift.to(dtype)
    packed = cells.rows is None
    block = 262144 if packed else 65536
    leaf = torch.empty(B, dtype=torch.int64, device=q_raw.device)
    bestw = torch.empty(B, dtype=dtype, device=q_raw.device)
    for s in range(0, B, block):
        cb = cid[s : s + block]
        if packed:
            fld = cells.table[cb].to(dtype).split(K, dim=1)  # 13 x [b, K]
            tid = fld[12]
            ok = tid >= 0
        else:
            tid = cells.table[cb]  # [b, K] int32
            ok = tid >= 0
            r = cells.rows[torch.where(ok, tid, 0).long()].to(dtype)
            fld = r.unbind(-1)  # 12 x [b, K]
        dqx, dqy, dqz = (dq[s : s + block, j : j + 1] for j in range(3))
        c0 = fld[0] * dqx + fld[1] * dqy + fld[2] * dqz + fld[9]
        c1 = fld[3] * dqx + fld[4] * dqy + fld[5] * dqz + fld[10]
        c2 = fld[6] * dqx + fld[7] * dqy + fld[8] * dqz + fld[11]
        minw = torch.minimum(
            torch.minimum(torch.minimum(c0, c1), c2), 1.0 - c0 - c1 - c2
        )
        minw = torch.where(ok, minw, -torch.inf)
        best = torch.argmax(minw, dim=-1, keepdim=True)
        bestw[s : s + block] = minw.gather(1, best)[:, 0]
        leaf[s : s + block] = torch.clamp(tid.gather(1, best)[:, 0], min=0).long()
    return cid, leaf, bestw, q_std


# The longest walk of a query the cell index leaves to the walk.
FALLBACK_STEPS = 32


def locate_cells(
    tri: DeviceTriangulation,
    cells: CellIndex,
    q_raw,
    fallback: str = "auto",
    fallback_steps: int = FALLBACK_STEPS,
):
    """Batched location by the cell index, with the walk as fallback.

    One row gather per query scores the candidates of its cell in the query
    dtype (:func:`_locate_cells_score_2d`, :func:`_locate_cells_score_3d`);
    2D float32 queries on the card take the kernel ``ops.cells.cells2d_cuda``
    instead, which reads each row once and gives the same bits.  The best
    one's weights come from the anchored affine maps in the query dtype.
    Queries that the index cannot settle walk from their cell's hint for
    at most ``fallback_steps`` steps: those in an overflowed cell or
    outside the cube that no candidate contains, those whose score and
    weights disagree, and, for an incomplete index, every query that no
    candidate contains.  ``fallback="none"`` skips the walk: not-contained
    queries then report in_domain=False.  2D float32 queries on the card
    walk in one launch of ``ops.walk.walk2d_cuda``, which gives the bits of
    :func:`locate`'s loop, the route of every other query.

    The walk takes exactly the queries that need it, found by one host
    read, so the JAX package's ``fallback_frac`` buffer has no counterpart.
    That read adds 1 to the module's ``locate_cells_host_reads``.  The
    scoring, through the mask of the queries to walk, is the span
    ``device_tri.locate_cells.score``; the read is
    ``device_tri.locate_cells.select``.  The kernel's walk is the span
    ``device_tri.locate`` too, and counts as the loop does (one host read).

    Returns (leaf [B] int64, weights [B, d+1], in_domain [B]).
    """
    on_card = cells_on_card(
        q_raw.device.type, tri.dim, q_raw.dtype, cells.table.dtype,
        tri.affine.dtype,
    )
    if on_card:
        q_raw = q_raw.contiguous()
    with profiling.span("device_tri.locate_cells.score"):
        if tri.dim == 3:
            cid, leaf, bestw, q_std = _locate_cells_score_3d(
                tri, cells, q_raw
            )
            w, in_domain, bad = _settle(
                tri, cells, q_raw, cid, leaf, bestw, q_std
            )
        elif on_card:
            leaf, w, in_domain, bad = cells_ops.cells2d_cuda(
                q_raw, tri.shift, tri.scale, cells.table,
                cells.overflow, tri.affine, cells.res, cells.k,
                cells.complete,
            )
        else:
            leaf, w, in_domain, bad = _locate_cells_score_2d(
                tri, cells, q_raw
            )
    if fallback == "none":
        return leaf, w, in_domain
    idx = _select(bad)
    if idx.numel() == 0:
        return leaf, w, in_domain
    walk = _walk_2d_on_card if on_card else _walk_in_loop
    walk(tri, cells, q_raw, idx, fallback_steps, leaf, w, in_domain)
    return leaf, w, in_domain


# The host reads of ``locate_cells``'s walk mask: one a call that may walk.
locate_cells_host_reads = 0


def cells_on_card(device_type: str, dim: int, *dtypes) -> bool:
    """Whether the cell route runs its hand-written kernels: 2D on CUDA,
    with every one of ``dtypes`` (the queries', the index table's and the
    affine maps'; for :func:`interp` the responses' too) float32."""
    return (
        device_type == "cuda"
        and dim == 2
        and all(d == torch.float32 for d in dtypes)
    )


def _select(bad):
    """The rows of the walk mask ``bad`` [B] to walk, int64 [M]: one host
    read, the span ``device_tri.locate_cells.select``."""
    global locate_cells_host_reads
    with profiling.span("device_tri.locate_cells.select"):
        locate_cells_host_reads += 1
        return torch.nonzero(bad)[:, 0]


def _walk_in_loop(tri, cells, q_raw, idx, max_steps, leaf, w, in_domain):
    """:func:`locate_cells`'s walk of rows ``idx`` of the queries by
    :func:`locate`'s loop, each from its cell's hint; the results are
    written in place, ``in_domain`` with every weight > -0.5."""
    q_walk = q_raw[idx]
    _, cid = _cells_of(tri, cells.res, q_walk)
    sub_leaf, sub_w, sub_in = locate(
        tri, q_walk, start=cells.hint[cid], max_steps=max_steps
    )
    leaf[idx] = sub_leaf
    w[idx] = sub_w
    in_domain[idx] = sub_in & torch.all(sub_w > -0.5, dim=-1)


def _walk_2d_on_card(
    tri, cells, q_raw, idx, max_steps, leaf, w, in_domain, values=None
):
    """:func:`locate_cells`'s walk of rows ``idx`` of float32 queries on
    the card, in one launch of ``ops.walk.walk2d_cuda``: each query walks
    from its cell's hint to its end, and its leaf, weights and in_domain
    are written in place (with ``values``, the kernel's value mode, its
    value alone).  The span and the counters are :func:`locate`'s;
    ``locate.steps`` grows by the steps the loop would have taken, from
    the kernel's largest iteration count, fetched by one host read."""
    with profiling.span("device_tri.locate"):
        n_max = walk_ops.walk2d_cuda(
            q_raw, idx, tri.shift, tri.scale, cells.hint, cells.res,
            tri.tri_nbrs, tri.affine, max_steps, leaf, w, in_domain,
            values=values,
        )
        locate.host_reads += 1
        locate.steps += lockstep_steps(int(n_max), max_steps)
        locate.queries += idx.numel()


# ---------------------------------------------------------------------------
# Batched evaluation
# ---------------------------------------------------------------------------


def vertex_responses(tri: DeviceTriangulation, response_ext) -> torch.Tensor:
    """Per-triangle response rows: [T, d+1], and in 2D [T, 4] with a zero
    in the last column, so that a float32 row is one 16-byte load.

    Pass the result to :func:`interp` as ``resp_tri``: evaluation then does
    one row gather instead of two chained gathers, and the 2D cell route
    on the card (:func:`interp_cells_on_card`) reads it from its kernels.
    """
    rows = response_ext[tri.tri_verts]
    if tri.dim == 2:
        rows = torch.nn.functional.pad(rows, (0, 1))
    return rows.contiguous()


def auto_method(
    device_type: str, dim: int, dtype, n_tris: int, cells_given: bool
) -> str:
    """The locate route that ``interp(method="auto")`` takes.

    The cell index when one is given; else the Hopper locate kernel for 2D
    float32 triangulations on CUDA up to ``PALLAS_LOCATE_MAX_TRIS``
    triangles; else the matmul brute force up to ``DENSE_LOCATE_MAX_TRIS``;
    else the walk.  The kernel scores in float32, so a float64
    triangulation never goes to it: its float32 tables can pick a
    neighbouring triangle whose float64 weights fail the float64 slack.
    """
    if cells_given and dim in (2, 3):
        return "cells"
    if (
        device_type == "cuda"
        and dim == 2
        and dtype == torch.float32
        and n_tris <= PALLAS_LOCATE_MAX_TRIS
    ):
        return "pallas"
    if n_tris <= DENSE_LOCATE_MAX_TRIS:
        return "dense"
    return "walk"


def interp(
    tri: DeviceTriangulation,
    response_ext,
    q_raw,
    max_steps: int = 256,
    method: str = "auto",
    cells: CellIndex | None = None,
    resp_tri=None,
):
    """Barycentric interpolation at raw query points [B, d], batched.

    The device analog of find_leaf + interp_point (linear_simplex.c:331-402,
    678-711): cage rows of the response are zero (see
    :func:`reindex_response`), and out-of-cage queries return 0.

    method: "auto" takes the route of :func:`auto_method`.  "cells" uses
    ``cells`` (:func:`build_cell_index`), "pallas" the locate kernel (its
    plain version on the CPU), "dense" the matmul brute force, "walk" the
    visibility walk of at most ``max_steps`` steps.  ``resp_tri``: the
    triangles' response rows (:func:`vertex_responses`), read in place of
    ``response_ext`` where given.  The cell route of 2D float32 queries and
    responses on the card is :func:`interp_cells_on_card`, whose kernels
    write the values from the response rows; every other route locates,
    then gathers and sums in torch (its plain version).
    """
    if method == "auto":
        method = auto_method(
            q_raw.device.type, tri.dim, tri.dtype, tri.n_tris,
            cells is not None,
        )
    if method == "cells":
        if cells is None:
            raise errors.InvalidArgumentError(
                "method='cells' needs a CellIndex (build_cell_index)"
            )
        resp = response_ext if resp_tri is None else resp_tri
        if cells_on_card(
            q_raw.device.type, tri.dim, q_raw.dtype, cells.table.dtype,
            tri.affine.dtype, resp.dtype,
        ):
            if resp_tri is None:
                resp_tri = vertex_responses(tri, response_ext)
            return interp_cells_on_card(tri, resp_tri, q_raw, cells)
        leaf, w, in_domain = locate_cells(tri, cells, q_raw)
    elif method == "pallas":
        leaf, w = locate_ops.locate_weights_kernel(tri, q_raw)
        in_domain = _in_domain(w)
    elif method == "dense":
        leaf, w, in_domain = locate_dense(tri, q_raw)
    elif method == "walk":
        leaf, w, in_domain = locate(tri, q_raw, max_steps=max_steps)
        # A capped or cycled walk can stop with wildly violated weights
        # (e.g. at a degenerate simplex): out of domain, not garbage.
        in_domain = in_domain & torch.all(w > -0.5, dim=-1)
    else:
        raise errors.InvalidArgumentError(f"unknown method {method!r}")
    if resp_tri is not None:
        vals = resp_tri[leaf, : tri.dim + 1]  # one row gather
    else:
        vals = response_ext[tri.tri_verts[leaf]]
    out = torch.sum(w * vals, dim=-1)
    return torch.where(in_domain, out, 0.0)


interp.fused_evals = 0


def interp_cells_on_card(
    tri: DeviceTriangulation, resp_rows, q_raw, cells: CellIndex
):
    """:func:`interp` by the cell index for 2D float32 queries on the card,
    the values written by the kernels' epilogues from the triangles'
    response rows ``resp_rows`` (:func:`vertex_responses`, [T, 4]
    float32): one launch of ``ops.cells.cells2d_cuda`` in value mode, the
    host read of the walk mask, and, where a query needs it, one launch of
    ``ops.walk.walk2d_cuda`` in value mode into the same values.

    The same values, to the bit, as :func:`locate_cells` followed by
    :func:`interp`'s tail on the card; no leaf, weight or ``in_domain``
    tensor is made.  The spans and counters are ``locate_cells``'s and the
    walk's; each call adds one to ``interp.fused_evals``.
    """
    q_raw = q_raw.contiguous()
    with profiling.span("device_tri.locate_cells.score"):
        vals, bad = cells_ops.cells2d_cuda(
            q_raw, tri.shift, tri.scale, cells.table, cells.overflow,
            tri.affine, cells.res, cells.k, cells.complete,
            values=resp_rows,
        )
    idx = _select(bad)
    if idx.numel():
        _walk_2d_on_card(
            tri, cells, q_raw, idx, FALLBACK_STEPS, None, None, None,
            values=(resp_rows, vals),
        )
    interp.fused_evals += 1
    return vals
