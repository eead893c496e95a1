"""Plain reference of the linear Delaunay interpolant (GSL's linear_simplex, 2D).

The value at a query q is sum_i w_i v_i over the triangle that contains q
in the Delaunay triangulation of the sites and a caging triangle, w the
barycentric weights of q and the cage vertices' values 0
(linear_simplex.c:134-296 builds the triangulation, :678-711 evaluates).
This module works it out from the sites, the values and the queries alone,
in plain PyTorch, for a sample of queries, without triangulating the whole
set:

* Lifting.  Put each point p at the height |p - q|^2.  The Delaunay
  triangle that contains q lies under the facet of the lower convex hull of
  the lifted points above q: of all triangles of points that contain q, it
  is the one whose lifted plane is lowest at q, the least
  L = sum_i w_i |p_i - q|^2.
* Candidates.  The k sites nearest q and the three cage vertices.  The
  lowest triangle among them has no candidate inside its circumcircle.
* Certificate.  No site but the candidates lies closer to q than the
  (k+1)-th nearest site.  If the circumcircle lies inside that disc, no
  site at all lies inside the circumcircle, and the triangle is the
  Delaunay one.  A query whose circle reaches farther is held against
  every site; the sites found inside its circle join its candidates, and it
  is solved again.
* Ties.  Where four points are cocircular to within what the build's
  precision can tell apart, both diagonals of their quadrilateral are
  Delaunay triangulations, and either triangle is a right answer.  The
  triangles whose L lies within ``tie`` of the least are returned beside
  it; ``tie`` is a height: the caller derives it from the precision that
  the configuration states (``tie_height``).

Nothing here imports the program under test.
"""

from __future__ import annotations

import itertools
import math

import torch

# How many nearest sites are candidates at first.
K_NEAREST = 16
# Rounds of doubling the candidates of a query left uncertified.
MAX_ROUNDS = 4
# Returned triangles per query: the lowest and up to this many - 1 ties.
MAX_TIES = 4
# Queries per pass (their bounding box stays small), and elements of the
# [queries, sites] power matrix of the check against every site.
QUERY_BLOCK = 128
SITE_BLOCK = 1 << 22


def cage_vertices(shift, scale, eps: float) -> torch.Tensor:
    """The caging triangle [3, 2] in raw coordinates, float64.

    linear_simplex.c:215-260: a regular triangle of unit circumradius
    (vertex i gets sqrt(1 - sum_{j<i} c_j^2) on axis i, and every later
    vertex -(1/d + that sum)/that value), scaled so that its inradius is
    1/eps**(1/5) (GSL_ROOT5_DBL_EPSILON of the working precision ``eps``),
    then taken back to raw coordinates by the inverse of the standardising
    map ``x_std = scale * (x - shift)``.
    """
    d = 2
    s = [[0.0] * d for _ in range(d + 1)]
    for i in range(d):
        tot2 = sum(s[i][j] ** 2 for j in range(i))
        chosen = math.sqrt(1.0 - tot2)
        s[i][i] = chosen
        for r in range(i + 1, d + 1):
            s[r][i] = -(1.0 / d + tot2) / chosen
    s = torch.tensor(s, dtype=torch.float64)
    inradius = (s[0, 0] - s[1, 0]) / (d + 1)
    s = s / (eps ** 0.2 * inradius)
    return s / torch.as_tensor(scale, dtype=torch.float64) + torch.as_tensor(
        shift, dtype=torch.float64
    )


def tie_height(jitter: float, rounding: float, radius):
    """Lifted height within which two triangulations of a near-cocircular
    quadrilateral cannot be told apart by a build that moves each site by
    up to ``jitter`` (per axis) and rounds coordinates to ``rounding``.

    Moving a point p by e changes |p - q|^2 by up to 2 |p - q| |e| + |e|^2;
    the four points of the quadrilateral lie within 2R of q (R the
    circumradius), so the heights of its two diagonals' planes at q move
    apart by at most 4 * 2 * 2R * sqrt(2) * (jitter + rounding).
    """
    e = math.sqrt(2.0) * (jitter + rounding)
    return 16.0 * radius * e + 4.0 * e * e


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 explicit mantissa bits), to
    nearest, ties away from zero, as the tensor cores' conversion does."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


def _triples(m: int, device) -> torch.Tensor:
    return torch.tensor(
        list(itertools.combinations(range(m), 3)), dtype=torch.long, device=device
    )


def _solve(u, z, vals, valid, tie_fn):
    """Lowest triangle of each query's candidates, and its ties.

    u [b, m, 2]: candidates relative to their query (origin = query);
    z [b, m]: their heights |u|^2; vals [b, m]; valid [b, m].
    Returns (value [b], ties [b, MAX_TIES] (NaN-padded, lowest first),
    centre [b, 2], radius [b], found [b]).
    """
    b, m, _ = u.shape
    t = _triples(m, u.device)
    a, bb, c = u[:, t[:, 0]], u[:, t[:, 1]], u[:, t[:, 2]]  # [b, T, 2]

    def cross(p, r):
        return p[..., 0] * r[..., 1] - p[..., 1] * r[..., 0]

    la, lb, lc = cross(bb, c), cross(c, a), cross(a, bb)
    det = la + lb + lc
    ok = valid[:, t].all(dim=-1) & (det != 0)
    det = torch.where(ok, det, 1.0)
    w = torch.stack([la, lb, lc], dim=-1) / det[..., None]  # [b, T, 3]
    ok = ok & (w >= 0).all(dim=-1)
    L = (w * z[:, t]).sum(-1)
    L = torch.where(ok, L, torch.inf)
    order = torch.argsort(L, dim=-1)[:, :MAX_TIES]
    Lk = L.gather(1, order)
    best = order[:, 0]
    found = torch.isfinite(Lk[:, 0])
    rows = torch.arange(b, device=u.device)
    tb = t[best]  # [b, 3]
    pa, pb, pc = u[rows, tb[:, 0]], u[rows, tb[:, 1]], u[rows, tb[:, 2]]
    # Circumcentre of (pa, pb, pc), relative to the query.
    ab, ac = pb - pa, pc - pa
    dd = 2.0 * cross(ab, ac)
    dd = torch.where(dd != 0, dd, 1.0)
    ab2, ac2 = (ab * ab).sum(-1), (ac * ac).sum(-1)
    ox = (ac[:, 1] * ab2 - ab[:, 1] * ac2) / dd
    oy = (ab[:, 0] * ac2 - ac[:, 0] * ab2) / dd
    off = torch.stack([ox, oy], dim=-1)
    centre = pa + off
    radius = torch.sqrt((off * off).sum(-1))
    tie = Lk[:, :1] + tie_fn(radius)[:, None]
    keep = torch.isfinite(Lk) & (Lk <= tie)
    v = (w.gather(1, order[..., None].expand(-1, -1, 3))
         * vals[:, t].gather(1, order[..., None].expand(-1, -1, 3))).sum(-1)
    ties = torch.where(keep, v, torch.nan)
    return ties[:, 0], ties, centre, radius, found


def _nearest(q, S, k, margin):
    """(indices [b, k], reach [b]): the k sites nearest each query, and a
    distance within which no other site lies.

    Only the sites in the queries' bounding box grown by ``margin`` are
    searched, so ``reach`` is the lesser of the distance to the (k+1)-th
    of them and each query's distance to the box's edge.
    """
    lo, hi = q.min(0).values - margin, q.max(0).values + margin
    box = ((S >= lo) & (S <= hi)).all(dim=1).nonzero()[:, 0]
    edge = torch.minimum(q - lo, hi - q).amin(dim=1)
    if box.numel() <= k:
        box = torch.arange(S.shape[0], device=S.device)
        edge = torch.full_like(edge, torch.inf)
    dist = torch.cdist(q, S[box], compute_mode="donot_use_mm_for_euclid_dist")
    kk = min(k + 1, box.numel())
    dist, idx = torch.topk(dist, kk, dim=1, largest=False)
    reach = dist[:, k] if kk > k else torch.full_like(edge, torch.inf)
    return box[idx[:, :k]], torch.minimum(reach, edge)


def interpolate(
    sites,
    values,
    queries,
    cage,
    tie_fn=None,
    precision: str = "float64",
):
    """Reference values of the linear Delaunay interpolant at ``queries``.

    sites [N, 2], values [N], queries [M, 2], cage [3, 2] (cage values 0).
    ``tie_fn(radius) -> height``: the tie tolerance (default none).
    ``precision``: "float64", or "tf32" for the control: sites, queries and
    values rounded to TF32 and every operation in float32 (the arithmetic
    of a TF32 tensor-core product, applied throughout).

    A query starts with the ``K_NEAREST`` nearest sites; one whose circle
    is neither certified nor found empty by the check against every site
    tries again with twice as many (and twice the search margin), for
    ``MAX_ROUNDS`` rounds.

    Returns (value [M], ties [M, MAX_TIES] NaN-padded, n_uncertified):
    ``ties[:, 0]`` is the lowest triangle's value.  In float64 a query
    that stays uncertified raises; the control keeps its lowest local
    triangle and counts it.
    """
    if precision == "float64":
        dt = torch.float64

        def rnd(x):
            return x.to(dt)
    elif precision == "tf32":
        dt = torch.float32

        def rnd(x):
            return _round_tf32(x.to(torch.float32))
    else:
        raise ValueError(f"unknown precision {precision!r}")
    if tie_fn is None:
        def tie_fn(r):
            return torch.zeros_like(r)
    dev = sites.device
    S, V = rnd(sites), rnd(values)
    Q, C = rnd(queries.to(dev)), rnd(cage.to(dev))
    N, M = S.shape[0], Q.shape[0]
    out_v = torch.full((M,), torch.nan, dtype=dt, device=dev)
    out_t = torch.full((M, MAX_TIES), torch.nan, dtype=dt, device=dev)
    # Queries in tile order, so that a pass's bounding box stays small; the
    # box's margin holds about 3 x the k-th neighbour's distance of sites
    # spread evenly over their bounding box.
    lo, hi = S.min(0).values, S.max(0).values
    tiles = max(1, int(math.sqrt(M / 128)))
    cell = ((Q - Q.min(0).values) / (Q.max(0).values - Q.min(0).values + 1e-30) * tiles)
    cell = cell.long().clamp(0, tiles - 1)
    todo = torch.argsort(cell[:, 1] * tiles + cell[:, 0])
    k = min(K_NEAREST, N)
    margin = 3.0 * math.sqrt((k + 1) * float((hi - lo).prod()) / (math.pi * N))
    for rnd_i in range(MAX_ROUNDS + 1):
        m = k + 3
        # Queries per pass: the [b, N] distances and the [b, C(m, 3)]
        # triples each stay near 1 GiB.
        per = max(1, min(QUERY_BLOCK, (1 << 24) // (m * (m - 1) * (m - 2) // 6)))
        left = []
        for s0 in range(0, todo.numel(), per):
            ids = todo[s0:s0 + per]
            q = Q[ids]
            idx, reach = _nearest(q, S, k, margin)
            pts = torch.cat([S[idx], C.expand(ids.numel(), 3, 2)], dim=1)
            vals = torch.cat([V[idx], torch.zeros(ids.numel(), 3, dtype=dt, device=dev)], dim=1)
            u = pts - q[:, None, :]
            valid = torch.ones(u.shape[:2], dtype=torch.bool, device=dev)
            value, ties, centre, radius, found = _solve(u, (u * u).sum(-1), vals, valid, tie_fn)
            out_v[ids], out_t[ids] = value, ties
            # Certified: every site within ``tie`` of the circle (power
            # below it: the circle, or a near-cocircular fourth point of a
            # tie) is a candidate.  Locally: that enlarged circle lies
            # inside the disc that holds only candidates (a relative margin
            # covers rounding).
            tau = tie_fn(radius)
            span = torch.sqrt((centre * centre).sum(-1)) + torch.sqrt(radius * radius + tau)
            ok = found & (span < reach * (1.0 - 1e-9))
            # Else count the sites near the circle among all sites and among
            # the candidates, by the same arithmetic.
            c_abs, r2 = centre + q, radius * radius
            rows = (~ok).nonzero()[:, 0]
            per_site = max(1, SITE_BLOCK // N)
            for j0 in range(0, rows.numel(), per_site):
                r = rows[j0:j0 + per_site]
                lim = (tau[r] - 1e-9 * r2[r])[:, None]
                near_all = ((((S[None] - c_abs[r, None]) ** 2).sum(-1) - r2[r, None]) < lim).sum(1)
                near_cand = ((((S[idx[r]] - c_abs[r, None]) ** 2).sum(-1) - r2[r, None]) < lim).sum(1)
                ok[r] = found[r] & (near_all == near_cand)
            left.append(ids[~ok])
        todo = torch.cat(left)
        if todo.numel() == 0 or k >= N:
            break
        k, margin = min(2 * k, N), 2.0 * margin
    if todo.numel() and precision == "float64":
        raise RuntimeError(f"reference: {todo.numel()} queries left uncertified")
    return out_v, out_t, int(todo.numel())


def admitted(config: dict, sites, values, queries, device, precision="float64"):
    """:func:`interpolate` for a configuration: (value [M], ties [M, k],
    n_uncertified) at ``queries`` [M, 2].

    The cage is GSL's for the configuration's working precision, about
    [-0.5, 0.5]^2 under ``NOSTANDARDIZE`` and the sites' bounding box
    otherwise.  The tie height follows from what the build's predicates
    see: each site moved by its jitter (``predicates.jitter_ulps`` ulps of
    the standardised coordinates) and rounded to the working precision
    (half an ulp of the largest coordinate).
    """
    sites = torch.as_tensor(sites, dtype=torch.float64, device=device)
    values = torch.as_tensor(values, dtype=torch.float64, device=device)
    if config["flags"] == "NOSTANDARDIZE":
        lo, hi = torch.full((2,), -0.5), torch.full((2,), 0.5)
    else:
        lo, hi = sites.min(0).values.cpu(), sites.max(0).values.cpu()
    shift, scale = (lo + hi) / 2, 1.0 / (hi - lo)
    eps = float(torch.finfo(getattr(torch, config["dtype"])).eps)
    cage = cage_vertices(shift, scale, eps)
    jitter = config["predicates"]["jitter_ulps"] * eps / float(scale.min())
    rounding = 0.5 * eps * float(torch.maximum(lo.abs(), hi.abs()).max())

    def tie_fn(radius):
        return tie_height(jitter, rounding, radius)

    return interpolate(sites, values, queries.to(device), cage, tie_fn=tie_fn,
                       precision=precision)
