"""Device Delaunay build for any d >= 2: parallel Bowyer-Watson rounds.

The counterpart of ``gsl_scattered_interpolation_tpu/models/device_cavity.py``
and the ``engine="cavity"`` of :class:`ScatteredInterp` (the default for
d = 3).  The reference restores Delaunayness by bistellar flips
(edge_flip.c), which can get stuck for d >= 3; this engine inserts by
cavities instead, as the host engine does (``models/host_tree.py``), with an
independent set of sites per round:

  round:
    1. every alive simplex claims its lowest-id uninserted site (a
       scatter-min); an evenly strided subset of the claims, about
       ``n_tris / s_div`` and at most S, become the round's candidates;
    2. each candidate grows its Bowyer-Watson cavity (the connected
       simplexes whose circumsphere holds the site) by a breadth-first
       search over neighbour links into a fixed [S, C] buffer;
    3. a candidate wins iff it owns every simplex of its cavity and of its
       one-ring halo (a scatter-min of site ids); ``waves`` further passes
       admit the losers that touch no winner.  Winners' cavities are
       separated by untouched simplexes, so their insertions commute;
    4. winners re-star their cavity: each boundary face becomes a simplex
       with the site in slot 0.  Carved slots are reused first, the rest
       allocated by prefix sum; sibling links come from matching the faces'
       ridges after a lexicographic sort, and a cavity whose boundary is
       not a closed manifold is deferred;
    5. uninserted sites of a carved simplex move to the new simplex where
       their smallest barycentric weight is largest.

A round with no winner doubles the cavity capacity C.  Every in-sphere and
relocation decision uses the compensated predicates of ``ops/robust.py``,
the direct determinant form (never a circumcentre solve).

Differences from the JAX package (recorded in ROADMAP.md):
  * the state arrays carry one trash row after their M real slots, which
    takes the writes that JAX drops (``mode="drop"``);
  * the ``while_loop``s are Python loops: the cavity growth reads its
    frontier once per level, relocation reads the affected count and the
    largest winner face count once per round, and :func:`build` reads
    ``n_left``, the winner count and ``n_tris`` once per round;
  * :func:`build` carries only the candidate rows a round can fill
    (``rows``), a prefix of S; the other rows are inactive in JAX;
  * no shape bucketing, no ``k_batch`` dispatch batching and no AOT cache:
    M and S come from the real site count, and an escalation of C is a
    larger buffer, not a recompile.
"""

from __future__ import annotations

import functools
import logging
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops import robust
from ..utils import errors
from . import device_delaunay, device_tri

log = logging.getLogger(__name__)

INT_MAX = 2**31 - 1
I32 = torch.int32
# Slots per site of the simplex buffer (steady-state counts plus transient:
# about 2N simplexes in 2D, 6.8N in 3D and 31N in 4D).
SLOTS_PER_SITE = {2: 2.2, 3: 9.0, 4: 45.0}
# Cavity capacity past which a stranded build gives up.
MAX_CAVITY = 4096


class CavityState(NamedTuple):
    """Build arrays; tri_v and tri_n hold M real slots plus the trash row M."""

    tri_v: torch.Tensor     # [M+1, d+1] int32 vertex ids (-1 = dead/unused)
    tri_n: torch.Tensor     # [M+1, d+1] int32 neighbour ids, -1 = boundary
    n_tris: torch.Tensor    # 0-d int32: allocated slots
    site_tri: torch.Tensor  # [N] int32: containing simplex per site; -1 done
    n_left: torch.Tensor    # 0-d int32: uninserted site count


def init_state(pts, N: int, M: int) -> CavityState:
    """The cage simplex in slot 0 and every site in it."""
    dp1 = pts.shape[-1] + 1
    dev = pts.device
    tri_v = torch.full((M + 1, dp1), -1, dtype=I32, device=dev)
    tri_v[0] = torch.arange(dp1, dtype=I32, device=dev)
    return CavityState(
        tri_v=tri_v,
        tri_n=torch.full((M + 1, dp1), -1, dtype=I32, device=dev),
        n_tris=torch.tensor(1, dtype=I32, device=dev),
        site_tri=torch.zeros(N, dtype=I32, device=dev),
        n_left=torch.tensor(N, dtype=I32, device=dev),
    )


def init_state_seeded(
    pts, N: int, M: int, tri_v0, tri_n0, site_tri0, n_left0
) -> CavityState:
    """A state that starts from an imported triangulation (the Qhull seed)."""
    dp1 = pts.shape[-1] + 1
    dev = pts.device
    T = tri_v0.shape[0]
    tri_v = torch.full((M + 1, dp1), -1, dtype=I32, device=dev)
    tri_v[:T] = torch.as_tensor(np.asarray(tri_v0, np.int32), device=dev)
    tri_n = torch.full((M + 1, dp1), -1, dtype=I32, device=dev)
    tri_n[:T] = torch.as_tensor(np.asarray(tri_n0, np.int32), device=dev)
    return CavityState(
        tri_v=tri_v,
        tri_n=tri_n,
        n_tris=torch.tensor(T, dtype=I32, device=dev),
        site_tri=torch.as_tensor(np.asarray(site_tri0, np.int32), device=dev),
        n_left=torch.tensor(int(n_left0), dtype=I32, device=dev),
    )


# ---------------------------------------------------------------------------
# Predicates
# ---------------------------------------------------------------------------


def _det3(m):
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1]
        * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2]
        * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def _insphere_det(verts, q):
    """Plain direct-determinant in-circumsphere test, any d.

    ``det[(v_i - q | |v_i - q|^2)] * sign(orient(verts))`` is positive iff q
    lies strictly inside the circumsphere; degenerate (zero-orientation)
    simplexes contain everything (linear_simplex.c:517-521).  The build
    uses the compensated forms below; this is their plain-arithmetic
    reference.
    """
    d = q.shape[-1]
    rel = verts - q[..., None, :]
    lift = torch.sum(rel * rel, dim=-1)
    if d == 2:
        a, b, c = rel[..., 0, :], rel[..., 1, :], rel[..., 2, :]
        la, lb, lc = lift[..., 0], lift[..., 1], lift[..., 2]
        det = (
            a[..., 0] * (b[..., 1] * lc - c[..., 1] * lb)
            - a[..., 1] * (b[..., 0] * lc - c[..., 0] * lb)
            + la * (b[..., 0] * c[..., 1] - c[..., 0] * b[..., 1])
        )
        e0 = verts[..., 1, :] - verts[..., 0, :]
        e1 = verts[..., 2, :] - verts[..., 0, :]
        orient = e0[..., 0] * e1[..., 1] - e0[..., 1] * e1[..., 0]
    elif d == 3:
        rows = torch.cat([rel, lift[..., None]], dim=-1)  # [.., 4, 4]

        def minor(skip):
            idx = [i for i in range(4) if i != skip]
            return _det3(rows[..., idx, :][..., :, :3])

        det = -(
            -rows[..., 0, 3] * minor(0)
            + rows[..., 1, 3] * minor(1)
            - rows[..., 2, 3] * minor(2)
            + rows[..., 3, 3] * minor(3)
        )
        orient = _det3(verts[..., 1:, :] - verts[..., :1, :])
    else:
        rows = torch.cat([rel, lift[..., None]], dim=-1)
        det = torch.linalg.det(rows) * ((-1.0) ** d)
        orient = torch.linalg.det(verts[..., 1:, :] - verts[..., :1, :])
    inside = det * torch.sign(orient) > 0
    return torch.where(orient == 0, True, inside)


def _insphere_robust3d(verts, q):
    """Compensated 3D in-circumsphere; degenerate tetrahedra contain
    everything."""
    S, O = robust.insphere_orient3d_ds(*(verts[..., k, :] for k in range(4)), q)
    return torch.where(O == 0, True, S * torch.sign(O) > 0)


def _minw_robust3d(verts, q):
    """Compensated smallest barycentric weight of q in each tetrahedron
    (ratios of compensated orient3d determinants); -inf if degenerate.

    The five determinants (the tetrahedron's, then with vertex i replaced
    by q) are evaluated stacked: one launch per operation."""
    v = [verts[..., k, :] for k in range(4)]
    qe = q.expand_as(v[0])
    O = robust.orient3d_ds(
        *(torch.stack([v[k]] + [qe if i == k else v[k] for i in range(4)])
          for k in range(4))
    )
    D, O0, O1, O2, O3 = O.unbind(0)
    ok = D != 0
    safe = torch.where(ok, D, 1.0)
    mn = torch.minimum(torch.minimum(O0, O1), torch.minimum(O2, O3))
    mx = torch.maximum(torch.maximum(O0, O1), torch.maximum(O2, O3))
    minw = torch.where(D > 0, mn, mx) / safe
    return torch.where(ok, minw, -torch.inf)


def _insphere_robust_nd(verts, q):
    """Compensated any-d in-circumsphere (cofactor expansion)."""
    S = robust.inspherend_ds(verts, q)
    O = robust.orientnd_ds(verts)
    return torch.where(O == 0, True, S * torch.sign(O) > 0)


def _minw_robust_nd(verts, q):
    """Compensated smallest barycentric weight, any d: orientation
    determinants with vertex i replaced by q, stacked as in
    :func:`_minw_robust3d`."""
    dp1 = verts.shape[-2]
    qrow = q[..., None, :].expand(*verts.shape[:-2], 1, verts.shape[-1])
    O = robust.orientnd_ds(torch.stack(
        [verts]
        + [torch.cat([verts[..., :i, :], qrow, verts[..., i + 1 :, :]], -2)
           for i in range(dp1)]
    ))
    D, Os = O[0], O[1:]
    mn = functools.reduce(torch.minimum, Os.unbind(0))
    mx = functools.reduce(torch.maximum, Os.unbind(0))
    ok = D != 0
    safe = torch.where(ok, D, 1.0)
    minw = torch.where(D > 0, mn, mx) / safe
    return torch.where(ok, minw, -torch.inf)


def _insphere_robust2d(verts, q):
    """Compensated 2D in-circumcircle."""
    a, b, c = verts[..., 0, :], verts[..., 1, :], verts[..., 2, :]
    S = robust.incircle_ds(a, b, c, q)
    O = robust.orient2d_ds(a, b, c)
    return torch.where(O == 0, True, S * torch.sign(O) > 0)


def _minw_robust2d(verts, q):
    """Compensated smallest barycentric weight of q in each triangle."""
    v0, v1, v2 = verts[..., 0, :], verts[..., 1, :], verts[..., 2, :]
    D = robust.orient2d_ds(v0, v1, v2)
    O0 = robust.orient2d_ds(q, v1, v2)
    O1 = robust.orient2d_ds(v0, q, v2)
    O2 = robust.orient2d_ds(v0, v1, q)
    ok = D != 0
    safe = torch.where(ok, D, 1.0)
    minw = torch.minimum(torch.minimum(O0, O1), O2) / safe
    maxw = torch.maximum(torch.maximum(O0, O1), O2) / safe
    minw = torch.where(D > 0, minw, maxw)
    return torch.where(ok, minw, -torch.inf)


def _insphere(d):
    return {2: _insphere_robust2d, 3: _insphere_robust3d}.get(
        d, _insphere_robust_nd
    )


def _minw(d):
    return {2: _minw_robust2d, 3: _minw_robust3d}.get(d, _minw_robust_nd)


# ---------------------------------------------------------------------------
# One round
# ---------------------------------------------------------------------------


def _grow_cavities(pts, st: CavityState, sites_q, cand_tri, active, C: int):
    """Breadth-first Bowyer-Watson growth of S candidates' cavities.

    Each iteration expands one whole level: the untested neighbours of
    every frontier member (the slots appended last iteration) are tested
    together, deduplicated by a per-row sort and appended by prefix rank.
    The in-sphere test runs only on the existing neighbours of frontier
    members, compacted by one ``nonzero`` (the level's one host read; the
    loop ends when none is left, where JAX's ends when no frontier is).  A
    row whose cavity would pass C simplexes stops and reports overflow.

    Returns (cav [S, C] simplex ids (-1 pad), n_cav [S], overflow [S]).
    """
    S = cand_tri.shape[0]
    d = pts.shape[-1]
    dp1 = d + 1
    dev = pts.device
    insphere = _insphere(d)
    cav = torch.full((S, C), -1, dtype=I32, device=dev)
    cav[:, 0] = torch.where(active, cand_tri, -1)
    n_cav = active.to(I32)
    ptr = torch.zeros(S, dtype=I32, device=dev)  # frontier: [ptr, n_cav)
    ov = torch.zeros(S, dtype=torch.bool, device=dev)
    col = torch.arange(C, dtype=I32, device=dev)[None, :]
    base = torch.arange(S, dtype=I32, device=dev)[:, None] * C
    while True:
        act = (ptr < n_cav) & ~ov
        frontier = (col >= ptr[:, None]) & (col < n_cav[:, None]) & ~ov[:, None]
        cur = torch.where(frontier, cav, 0)
        nbrs = st.tri_n[cur.long()]  # [S, C, d+1]
        nb_ok = frontier[:, :, None] & (nbrs >= 0)
        idx = torch.nonzero(nb_ok.reshape(-1))[:, 0]  # one host read per level
        if idx.numel() == 0:  # nothing left to test: no row changes
            break
        verts = pts[st.tri_v[nbrs.reshape(-1)[idx].long()].long()]
        q = sites_q[idx // (C * dp1)]
        viol = torch.zeros(S * C * dp1, dtype=torch.bool, device=dev)
        viol[idx] = insphere(verts, q)
        seen = torch.any(nbrs[:, :, :, None] == cav[:, None, None, :], dim=-1)
        add = nb_ok & viol.reshape(S, C, dp1) & ~seen
        # Two frontier members can share a violating neighbour: sort each
        # row and keep the first of every run.
        prop = torch.sort(
            torch.where(add, nbrs, INT_MAX).reshape(S, C * dp1), dim=1
        ).values
        uniq = prop != INT_MAX
        uniq[:, 1:] &= prop[:, 1:] != prop[:, :-1]
        rank = torch.cumsum(uniq.to(I32), 1, dtype=I32) - 1
        cnt = torch.sum(uniq, 1, dtype=I32)
        would = n_cav + cnt
        ov_new = ov | (act & (would > C))
        keep = uniq & ~ov_new[:, None]
        flat_pos = torch.where(keep, base + n_cav[:, None] + rank, S * C)
        cav = (
            torch.cat([cav.reshape(-1), cav.new_full((1,), -1)])
            .index_put((flat_pos.reshape(-1).long(),), prop.reshape(-1))[: S * C]
            .reshape(S, C)
        )
        ptr = torch.where(act, n_cav, ptr)
        n_cav = torch.where(act & ~ov_new, would, n_cav)
        ov = ov_new
    return cav, n_cav, ov


def _lexsort_rows(cols):
    """Per-row lexicographic order of [S, L] int columns, ``cols[0]``
    primary, ties by position: stable sorts from the last column on
    (``jnp.lexsort`` of the reversed columns)."""
    S, L = cols[0].shape
    order = torch.arange(L, device=cols[0].device).expand(S, L)
    for c in reversed(cols):
        _, o = torch.sort(c.gather(1, order), dim=1, stable=True)
        order = order.gather(1, o)
    return order


def _round(pts, st: CavityState, S: int, C: int, s_div: int = 16,
           waves: int = 4, rows: int | None = None):
    """One parallel cavity-insertion round (see the module docstring).

    ``rows``: how many of the S candidate rows to carry.  A round fills at
    most ``clip(n_tris // s_div, 4, S)`` of them, a prefix, so passing that
    number (read from ``n_tris`` on the host) gives the same state as S.

    Returns (state, n_winners [0-d int32]).
    """
    M = st.tri_v.shape[0] - 1
    dp1 = st.tri_v.shape[1]
    d = dp1 - 1
    N = st.site_tri.shape[0]
    dev = pts.device
    dtype = pts.dtype
    F = 2 * C + 2 if d >= 3 else C + 2  # max boundary faces of a cavity
    Sr = S if rows is None else int(rows)
    site_ids = torch.arange(N, dtype=I32, device=dev)
    rows_s = torch.arange(Sr, dtype=I32, device=dev)
    colC = torch.arange(C, dtype=I32, device=dev)
    tri_v, tri_n, n_tris, site_tri, n_left = st

    # -- 1. claims and candidate pick -------------------------------------
    tgt = torch.where(site_tri >= 0, site_tri, M).long()
    claim = torch.full((M + 1,), INT_MAX, dtype=I32, device=dev)
    claim = claim.scatter_reduce(0, tgt, site_ids, "amin")[:M]
    has = claim != INT_MAX
    rank = torch.cumsum(has.to(I32), 0, dtype=I32) - 1
    n_claims = torch.clamp(torch.sum(has, dtype=I32), min=1)
    s_eff = torch.clamp(n_tris // s_div, 4, S)
    # Every ceil(n_claims / s_eff)-th claim: spread over the claim order.
    stride = torch.clamp((n_claims + s_eff - 1) // s_eff, min=1)
    picked = has & (rank % stride == 0)
    slot = torch.clamp(torch.where(picked, rank // stride, Sr), max=Sr).long()
    cand_tri = torch.full((Sr + 1,), -1, dtype=I32, device=dev).index_put(
        (slot,), torch.arange(M, dtype=I32, device=dev)
    )[:Sr]
    cand_site = torch.full((Sr + 1,), -1, dtype=I32, device=dev).index_put(
        (slot,), claim
    )[:Sr]
    active = cand_site >= 0
    spid = torch.where(active, cand_site + dp1, 0)  # point ids: 0..d cage
    q = pts[spid.long()]

    # -- 2. cavity growth -------------------------------------------------
    cav, n_cav, overflow = _grow_cavities(pts, st, q, cand_tri, active, C)
    memb = colC[None, :] < n_cav[:, None]
    cav_safe = torch.where(memb, cav, 0)

    # -- 3. halo ------------------------------------------------------------
    own_tgt = torch.where(memb, cav_safe, M).reshape(-1).long()
    halo = tri_n[cav_safe.long()]  # [Sr, C, d+1]
    halo_in_cav = torch.any(halo[:, :, :, None] == cav[:, None, None, :], dim=-1)
    halo_ok = memb[:, :, None] & (halo >= 0) & ~halo_in_cav
    halo_safe = torch.where(halo_ok, halo, 0).long()
    halo_tgt = torch.where(halo_ok, halo, M).reshape(-1).long()

    def own_pass(alive):
        """Halo-inclusive ownership among the ``alive`` candidates."""
        prio = torch.where(alive, cand_site, INT_MAX)
        owner = torch.full((M + 1,), INT_MAX, dtype=I32, device=dev)
        owner = owner.scatter_reduce(
            0, own_tgt, prio[:, None].expand(Sr, C).reshape(-1), "amin"
        )
        owner = owner.scatter_reduce(
            0, halo_tgt, prio[:, None, None].expand(Sr, C, dp1).reshape(-1),
            "amin",
        )[:M]
        mine_cav = owner[cav_safe.long()] == prio[:, None]
        mine_halo = owner[halo_safe] == prio[:, None, None]
        ok = torch.all(mine_cav | ~memb, 1) & torch.all(
            (mine_halo | ~halo_ok).reshape(Sr, -1), 1
        )
        return alive & ok

    # -- 4. boundary faces --------------------------------------------------
    is_bnd = memb[:, :, None] & ((halo < 0) | ~halo_in_cav)
    is_bnd = is_bnd & (active & ~overflow)[:, None, None]
    bflat = is_bnd.reshape(Sr, C * dp1)
    frank = torch.cumsum(bflat.to(I32), 1, dtype=I32) - 1
    n_face = torch.sum(bflat, 1, dtype=I32)
    face_ov = n_face > F  # non-manifold or pathological: defer
    bflat = bflat & ~face_ov[:, None]
    # face f of member m: the member's vertices without slot f, cyclic
    cav_verts = tri_v[cav_safe.long()]  # [Sr, C, d+1]
    take = (
        torch.arange(dp1, device=dev)[:, None] + 1
        + torch.arange(d, device=dev)[None, :]
    ) % dp1
    fverts = cav_verts[:, :, take.reshape(-1)].reshape(Sr, C, dp1, d)
    fown = cav_safe[:, :, None].expand(Sr, C, dp1)
    pos = torch.where(bflat, rows_s[:, None] * F + frank, Sr * F).reshape(-1)
    pos = pos.long()

    def compact(x):
        """Each per-face value to [Sr, F] by prefix-rank scatter (-1 fill)."""
        flat = torch.full((Sr * F + 1,), -1, dtype=x.dtype, device=dev)
        return flat.index_put((pos,), x.reshape(-1))[: Sr * F].reshape(Sr, F)

    fverts_c = torch.stack([compact(fverts[..., j]) for j in range(d)], -1)
    fext_c = compact(halo)
    fown_c = compact(fown)
    fcand = torch.arange(F, device=dev)[None, :] < n_face[:, None]

    # -- manifoldness guard ---------------------------------------------------
    # On exactly degenerate input a cavity can be pinched: some ridge then
    # belongs to other than two boundary faces, and the candidate is
    # deferred.  Two faces share a ridge iff their sorted (d-1)-vertex
    # tuples are equal, so a lexicographic sort of the ridge list puts
    # every ridge next to its partner.
    ridge_take = (
        torch.arange(d, device=dev)[:, None] + 1
        + torch.arange(d - 1, device=dev)[None, :]
    ) % d
    ridges = fverts_c[:, :, ridge_take.reshape(-1)].reshape(Sr, F, d, d - 1)
    Fd = F * d
    flat_rv = torch.sort(ridges, dim=-1).values.reshape(Sr, Fd, d - 1)
    ridge_valid = fcand[:, :, None].expand(Sr, F, d).reshape(Sr, Fd)
    order = _lexsort_rows(
        [torch.where(ridge_valid, flat_rv[..., j], INT_MAX) for j in range(d - 1)]
    )
    sv = flat_rv.gather(1, order[..., None].expand(Sr, Fd, d - 1))
    valid_s = ridge_valid.gather(1, order)
    eq = (
        torch.all(sv[:, 1:] == sv[:, :-1], dim=-1)
        & valid_s[:, 1:]
        & valid_s[:, :-1]
    )
    zero1 = torch.zeros((Sr, 1), dtype=torch.bool, device=dev)
    eqn = torch.cat([eq, zero1], 1)  # eq(i, i+1)
    eqp = torch.cat([zero1, eq], 1)  # eq(i-1, i)
    eqn_next = torch.cat([eqn[:, 1:], zero1], 1)
    eqp_prev = torch.cat([zero1, eqp[:, :-1]], 1)
    pair_first = eqn & ~eqp & ~eqn_next  # a run of exactly two, first
    pair_second = eqp & ~eqn & ~eqp_prev  # and second slot
    manifold = torch.all(
        torch.where(valid_s, pair_first | pair_second, True), dim=1
    )

    # -- ownership waves ----------------------------------------------------
    valid = active & ~overflow & ~face_ov & manifold
    win = own_pass(valid)
    for _ in range(max(waves - 1, 0)):
        closed = torch.zeros(M + 1, dtype=torch.bool, device=dev)
        closed[torch.where(memb & win[:, None], cav_safe, M).long()] = True
        closed[torch.where(halo_ok & win[:, None, None], halo_safe, M)] = True
        closed = closed[:M]
        t_cav = torch.any(memb & closed[cav_safe.long()], dim=1)
        t_halo = torch.any((halo_ok & closed[halo_safe]).reshape(Sr, -1), 1)
        alive = valid & ~win & ~t_cav & ~t_halo
        win = win | own_pass(alive)
    # Keep the prefix of winners whose fresh slots fit in M (dropping a
    # suffix leaves the earlier winners' slot bases unchanged).
    fresh = torch.clamp(n_face - n_cav, min=0)
    win = win & (n_tris + torch.cumsum(torch.where(win, fresh, 0), 0) <= M)
    fvalid = fcand & win[:, None]

    # -- slot allocation: reuse carved slots, bump the rest ------------------
    fresh_cnt = torch.where(win, fresh, 0)
    fresh_base = (n_tris + torch.cumsum(fresh_cnt, 0) - fresh_cnt).to(I32)
    j_idx = torch.arange(F, dtype=I32, device=dev)[None, :].expand(Sr, F)
    new_id = torch.where(
        j_idx < n_cav[:, None],
        cav.gather(1, torch.clamp(j_idx, max=C - 1).long()),
        fresh_base[:, None] + (j_idx - n_cav[:, None]),
    )
    new_id = torch.where(fvalid, new_id, -1)  # [Sr, F]
    n_tris = (n_tris + torch.sum(fresh_cnt)).to(I32)

    # carved slots left over when a cavity has more members than faces
    dead = memb & win[:, None] & (colC[None, :] >= n_face[:, None])
    tri_v = tri_v.index_put(
        (torch.where(dead, cav_safe, M).reshape(-1).long(),),
        tri_v.new_tensor(-1),
    )

    # -- write the new simplexes ----------------------------------------------
    nv = torch.cat([spid[:, None, None].expand(Sr, F, 1), fverts_c], -1)
    rows_new = torch.where(fvalid, new_id, M).reshape(-1).long()
    tri_v = tri_v.index_put((rows_new,), nv.reshape(-1, dp1))

    # -- neighbour wiring -------------------------------------------------------
    # Slots 1..d: the sibling sharing the ridge, the sorted neighbour of a
    # winner's every ridge (winners passed the manifold guard).
    partner_pos = torch.where(
        pair_first,
        torch.roll(order, -1, dims=1),
        torch.where(pair_second, torch.roll(order, 1, dims=1), 0),
    )
    has_partner = pair_first | pair_second
    sib = torch.zeros((Sr, Fd + 1), dtype=torch.int64, device=dev).scatter_(
        1, torch.where(has_partner, order, Fd), partner_pos // d
    )[:, :Fd]
    nn_rest = new_id.gather(1, sib).reshape(Sr, F, d)
    nn = torch.cat([fext_c[..., None], nn_rest], -1)
    tri_n = tri_n.index_put((rows_new,), nn.reshape(-1, dp1))

    # external back-pointers: the slot of ext that pointed at the carved owner
    ext_ok = fvalid & (fext_c >= 0)
    ext_safe = torch.where(ext_ok, fext_c, 0)
    ext_slot = torch.argmax(
        (tri_n[ext_safe.long()] == fown_c[..., None]).to(torch.uint8), dim=-1
    )
    flat_ext = torch.where(ext_ok, ext_safe * dp1 + ext_slot, M * dp1)
    tri_n = (
        tri_n.reshape(-1)
        .index_put((flat_ext.reshape(-1).long(),), new_id.reshape(-1))
        .reshape(M + 1, dp1)
    )

    # -- 5. relocate the sites of carved simplexes -----------------------------
    win_of = torch.full((M + 1,), -1, dtype=I32, device=dev).index_put(
        (torch.where(memb & win[:, None], cav_safe, M).reshape(-1).long(),),
        rows_s[:, None].expand(Sr, C).reshape(-1),
    )[:M]
    w_i = win_of[torch.where(site_tri >= 0, site_tri, 0).long()]
    needs = (site_tri >= 0) & (w_i >= 0)
    Fb = min(32, F)
    cnt, nf_max = torch.stack(
        [torch.sum(needs), torch.max(torch.where(win, n_face, 0))]
    ).tolist()  # one host read
    if cnt:
        rk = torch.cumsum(needs.to(I32), 0, dtype=I32) - 1
        csite = torch.zeros(cnt + 1, dtype=I32, device=dev).index_put(
            (torch.where(needs, rk, cnt).long(),), site_ids
        )[:cnt]
        flat_ids = new_id.reshape(-1)
        flat_ok = fvalid.reshape(-1)
        minw = _minw(d)
        R = int(min(16384, max(256, N)))
        for c0 in range(0, cnt, R):
            sb = csite[c0 : c0 + R].long()
            w_b = w_i[sb]
            q_b = pts[sb + dp1]
            best_w = torch.full(sb.shape, -torch.inf, dtype=dtype, device=dev)
            best_t = torch.zeros(sb.shape, dtype=I32, device=dev)
            for j in range(math.ceil(nf_max / Fb)):
                fidx = j * Fb + torch.arange(Fb, device=dev)
                inb = fidx < F
                gidx = w_b[:, None] * F + torch.where(inb, fidx, 0)[None, :]
                okj = flat_ok[gidx] & inb[None, :]
                tj = torch.where(okj, flat_ids[gidx], 0)
                verts = pts[tri_v[tj.long()].long()]  # [R, Fb, d+1, d]
                wj = torch.where(okj, minw(verts, q_b[:, None, :]), -torch.inf)
                jb = torch.argmax(wj, dim=-1, keepdim=True)
                wb = wj.gather(1, jb)[:, 0]
                better = wb > best_w
                best_w = torch.where(better, wb, best_w)
                best_t = torch.where(better, tj.gather(1, jb)[:, 0], best_t)
            site_tri = site_tri.index_put((sb,), best_t)

    # retire the inserted sites
    ins = torch.zeros(N + 1, dtype=torch.bool, device=dev).index_put(
        (torch.where(win, cand_site, N).long(),), torch.tensor(True, device=dev)
    )[:N]
    site_tri = torch.where(ins, -1, site_tri)
    n_w = torch.sum(win, dtype=I32)
    n_left = (n_left - n_w).to(I32)
    return CavityState(tri_v, tri_n, n_tris, site_tri, n_left), n_w


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def build(sites_std, cage_std, cavity_cap: int = 64, s_cap: int = 512,
          slots_per_site: float | None = None,
          init: CavityState | None = None, s_div: int = 32, waves: int = 4,
          stats: dict | None = None):
    """Rounds until every site is inserted (any d >= 2).

    ``sites_std`` [N, d] are the standardized, shuffled sites and
    ``cage_std`` [d+1, d] the cage, on the build's device and in its dtype.
    ``init`` is a seeded state (:func:`init_state_seeded`).  A round with no
    winner doubles the cavity capacity C, up to ``MAX_CAVITY``; a full slot
    buffer raises ``CapacityError``.  ``stats``, if given, receives
    ``rounds``, ``winners`` (per round), ``escalations`` and the final
    ``cavity_cap``.

    Returns (tri_v [M, d+1], tri_n [M, d+1], alive [M], n_tris).
    """
    N, d = sites_std.shape
    if slots_per_site is None:
        slots_per_site = SLOTS_PER_SITE.get(d, 100.0)
    M = int(slots_per_site * N) + 16 * (d + 1)
    pts = torch.cat([cage_std.to(sites_std.dtype), sites_std])
    st = init_state(pts, N, M) if init is None else init
    # S is fixed for the whole build.
    S = 1 << max(0, min(N, s_cap) - 1).bit_length()
    C = cavity_cap
    n_left, n_tris = torch.stack([st.n_left, st.n_tris]).tolist()
    winners = []
    while n_left > 0:
        rows = min(max(n_tris // s_div, 4), S)
        st, n_w = _round(pts, st, S, C, s_div=s_div, waves=waves, rows=rows)
        n_left, n_w, n_tris = torch.stack(
            [st.n_left, n_w, st.n_tris]
        ).tolist()  # one host read per round
        winners.append(n_w)
        if n_w == 0 and n_left > 0:
            if n_tris > M - (2 * C + 2):
                raise errors.CapacityError(
                    f"cavity build: slot capacity {M} exhausted ({n_tris} "
                    "allocated); raise slots_per_site"
                )
            C *= 2
            log.info("cavity build: round %d stranded, C -> %d",
                     len(winners), C)
            if C > MAX_CAVITY:
                raise RuntimeError(
                    f"cavity build: cavities exceed {MAX_CAVITY} simplexes"
                )
    if stats is not None:
        stats.update(
            rounds=len(winners), winners=winners,
            escalations=int(math.log2(C // cavity_cap)), cavity_cap=C,
        )
    tri_v, tri_n = st.tri_v[:M], st.tri_n[:M]
    return tri_v, tri_n, tri_v[:, 0] >= 0, st.n_tris


def _qhull_seed(sites_build, cage_std, dtype, seed_frac_div, exclude=None):
    """The seed of :func:`triangulate`: scipy's Qhull triangulation of the
    cage, the sites near the data box's boundary and a fill of the first
    sites, with every other site located in it.

    The sites within 0.75 mean spacings of the boundary all go into the
    seed, since a boundary site left out has a conflict region spanning the
    cage-gap slivers.  The seed holds ``n / fdiv`` sites, fdiv 1.25 up to
    20,000 sites, 2 up to 200,000 and 4 past it.  Qhull sees the coordinates
    rounded to ``dtype``, the point set of the build.  The sites of the
    boolean mask ``exclude`` stay out of the seed.

    Returns (tri_v0, tri_n0, site_tri0, n_left0) in numpy.
    """
    from scipy.spatial import Delaunay

    n, d = sites_build.shape
    if seed_frac_div is None:
        fdiv = 1.25 if n <= 20_000 else (2 if n <= 200_000 else 4)
    else:
        fdiv = seed_frac_div
    m = min(n, max(2048, int(n / fdiv)))
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    rounded = sites_build.astype(np_dtype).astype(np.float64)
    cage_r = cage_std.cpu().numpy().astype(np.float64)
    delta = 0.75 * n ** (-1.0 / d)
    bdist = np.minimum(rounded + 0.5, 0.5 - rounded).min(axis=1)
    in_seed = bdist < delta
    fill = np.nonzero(~in_seed)[0]
    in_seed[fill[: max(0, m - int(in_seed.sum()))]] = True
    if exclude is not None:
        in_seed &= ~exclude
    seed_ids = np.nonzero(in_seed)[0]
    rest_ids = np.nonzero(~in_seed)[0]
    sd = Delaunay(np.concatenate([cage_r, rounded[seed_ids]]))
    # Qhull's point ids (0..d cage, d+1+i = seed_ids[i]) to global ids.
    lmap = np.concatenate([np.arange(d + 1), seed_ids + d + 1]).astype(np.int32)
    tets0 = lmap[np.asarray(sd.simplices, np.int64)]
    nbrs0 = np.asarray(sd.neighbors, np.int32)
    loc = np.asarray(sd.find_simplex(rounded[rest_ids]), np.int64)
    miss = loc < 0
    if miss.any():  # rare: rounding on a cage-gap face
        loc[miss] = sd.find_simplex(rounded[rest_ids][miss], bruteforce=True)
        loc = np.maximum(loc, 0)
    site_tri0 = np.full(n, -1, np.int32)
    site_tri0[rest_ids] = loc.astype(np.int32)
    return tets0, nbrs0, site_tri0, n - len(seed_ids)


def _seed_violations(pts, tets, nbrs):
    """The point ids of an imported triangulation where it is not Delaunay:
    the vertices of each simplex whose neighbour's far vertex lies strictly
    inside its circumsphere, by the build's compensated predicate (a
    degenerate simplex counts as containing everything).  ``pts`` [P, d]
    are the build's points on its device."""
    tv = torch.as_tensor(np.asarray(tets, np.int64), device=pts.device)
    tn = torch.as_tensor(np.asarray(nbrs, np.int64), device=pts.device)
    T, dp1 = tv.shape
    uv = tv[tn.clamp(min=0)]  # [T, d+1 faces, d+1]: the neighbours' vertices
    far = ~torch.any(uv[..., :, None] == tv[:, None, None, :], dim=-1)
    opp = uv.gather(2, torch.argmax(far.to(torch.uint8), -1, keepdim=True))[..., 0]
    verts = pts[tv][:, None].expand(T, dp1, dp1, pts.shape[-1])
    viol = (tn >= 0) & _insphere(pts.shape[-1])(verts, pts[opp])
    return torch.unique(torch.cat([tv[viol.any(1)].reshape(-1), opp[viol]]))


# Seeds tried before the build starts without one (see triangulate).
SEED_TRIES = 4


def triangulate(
    sites_raw,
    lo=None,
    hi=None,
    flags: int = 0,
    key=None,
    dtype=torch.float64,
    grid_res: int = 256,
    cavity_cap: int = 64,
    s_cap: int = 512,
    slots_per_site: float | None = None,
    jitter_ulps: float | None = None,
    seed_import: str = "auto",
    seed_min: int = 4096,
    seed_frac_div: float | None = None,
    s_div: int = 32,
    waves: int = 2,
    device="cuda",
    stats: dict | None = None,
):
    """End to end for any d >= 2: standardize, cage, shuffle, build on
    ``device``, freeze.

    Returns a float64 DeviceTriangulation on ``device`` and the shuffle
    permutation, as ``device_delaunay.triangulate`` does.  The response of
    a build of d-dimensional sites is
    ``device_tri.response_for_build(shuffle, values, d=d)``: the default
    d = 2 would shift every value by one row in 3D.

    The sites are jittered for the build by ``jitter_ulps`` ulps of
    ``dtype`` (default: 0 in float32, whose every decision is compensated,
    and 2^16 in float64, so cospherical ties resolve consistently); the
    triangulation keeps the exact coordinates.  From ``seed_min`` sites on
    (``seed_import`` "auto" or "qhull"; "self" for none) the rounds start
    from a Qhull seed (:func:`_qhull_seed`).  Qhull can return simplexes that
    are not Delaunay: the float64 cage is about 1,350 times the data's size,
    and Qhull then merges nearly cospherical facets at the data's scale and
    triangulates them anyhow (5 data tetrahedra at 10,000 float64 sites,
    where the JAX package keeps them and its values differ from scipy's by
    6.1e-4).  So the seed is checked (:func:`_seed_violations`), the sites
    of its violations are left out and Qhull runs again, up to
    ``SEED_TRIES`` seeds; then the build starts without one.  ``stats``, if
    given, receives the host seconds of ``setup_s``, ``seed_s``,
    ``rounds_s`` and ``freeze_s``, ``seeded``, ``seed_sites``,
    ``seed_left_out`` and :func:`build`'s counts.
    """
    t0 = time.perf_counter()
    sites_raw = np.asarray(sites_raw, np.float64)
    n, d = sites_raw.shape
    if jitter_ulps is None:
        jitter_ulps = 0.0 if dtype == torch.float32 else float(1 << 16)
    shift, scale, shuffle, cage_raw, cage_std, sites_build = (
        device_delaunay.build_inputs(
            sites_raw, lo, hi, flags, key, dtype, jitter_ulps=jitter_ulps
        )
    )
    stats = {} if stats is None else stats
    cage_dev = cage_std.to(device)
    sites_dev = torch.as_tensor(sites_build, dtype=dtype, device=device)
    t1 = time.perf_counter()
    init = None
    left_out = np.zeros(n, bool)
    if seed_import in ("auto", "qhull") and n >= seed_min:
        pts = torch.cat([cage_dev, sites_dev])
        for _ in range(SEED_TRIES):
            tets0, nbrs0, site_tri0, n_left0 = _qhull_seed(
                sites_build, cage_std, dtype, seed_frac_div, left_out
            )
            bad = _seed_violations(pts, tets0, nbrs0).cpu().numpy() - (d + 1)
            if bad.size == 0:
                break
            left_out[bad[bad >= 0]] = True
            log.info("cavity build: the qhull seed is not Delaunay at %d "
                     "points; leaving their sites out", bad.size)
        else:
            log.warning("cavity build: no Delaunay qhull seed in %d tries; "
                        "building without one", SEED_TRIES)
            tets0 = None
        if tets0 is not None:
            if slots_per_site is None:
                slots_per_site = SLOTS_PER_SITE.get(d, 100.0)
            M = int(slots_per_site * n) + 16 * (d + 1)
            init = init_state_seeded(
                sites_dev, n, M, tets0, nbrs0, site_tri0, n_left0
            )
            log.info("cavity build: qhull seed of %d sites, %d simplexes",
                     n - n_left0, tets0.shape[0])
    t2 = time.perf_counter()
    tri_v, tri_n, alive, _ = build(
        sites_dev, cage_dev, cavity_cap=cavity_cap, s_cap=s_cap,
        slots_per_site=slots_per_site, init=init, s_div=s_div, waves=waves,
        stats=stats,
    )
    t3 = time.perf_counter()
    points_raw = np.concatenate([cage_raw, sites_raw[shuffle]])
    tri = device_tri.from_arrays(
        points_raw, shift, scale, tri_v, tri_n, alive, grid_res=grid_res,
        device=device,
    )
    if tri.device.type == "cuda":
        torch.cuda.synchronize(tri.device)
    stats.update(
        setup_s=t1 - t0, seed_s=t2 - t1, rounds_s=t3 - t2,
        freeze_s=time.perf_counter() - t3, seeded=init is not None,
        seed_sites=0 if init is None else n - n_left0,
        seed_left_out=int(left_out.sum()),
    )
    return tri, shuffle
