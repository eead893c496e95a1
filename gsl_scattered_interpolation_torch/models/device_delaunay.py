"""Device 2D Delaunay build: batched insertion rounds plus parallel flips.

The single-program route of ``gsl_scattered_interpolation_tpu/models/
device_delaunay.py``, ported function by function.  The reference inserts
one point at a time (linear_simplex.c:283-293, 404-492; edge_flip.c:211-320);
here every round inserts many sites at once over fixed-capacity arrays:

  round:
    1. every leaf claims the lowest-id uninserted site it contains
       (a scatter-min);
    2. all claimed leaves split 1->3 at once (the parent slot becomes one
       child, two fresh slots the others) and stale neighbour pointers are
       re-resolved by a gather pass;
    3. uninserted sites of a split leaf move to one of its 3 children;
    4. flip sub-rounds: every violating shared edge is a candidate (the
       verdict of ``ops/candmath.py``, a CUDA kernel on the card); a
       mutual-minimum matching picks a conflict-free set, matched pairs
       rewrite themselves in place, and straddling sites move across.

Flip decisions are canonical per quad (the incircle of the id-sorted quad),
so both sides of an edge reach the same verdict and the flips cannot
oscillate.  All predicates are the compensated ones of ``ops/robust.py``.

Point ids: 0..2 are the cage vertices, 3..N+2 the sites in insertion order.

Differences from the JAX package:
  * every state array has one spare "trash" row after its M real slots;
    writes that JAX drops (``mode="drop"`` at row M+1) go there, so a
    scatter needs no mask and no host sync.  Real target rows stay
    distinct, as in JAX; only the trash row takes duplicates;
  * the ``while_loop``s are Python loops that read ``n_left`` or
    ``any_flip`` from the device once per round;
  * no shape bucketing: the TPU's compile-cache padding changes no row of
    the result, because pad sites never claim and slots are allocated by
    prefix rank from ``n_tris``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import candmath, geometry, robust
from ..utils import machine
from ..utils import rng as rng_util
from . import device_tri, host_tree

INT_MAX = 2**31 - 1
I32 = torch.int32
# Flip sub-rounds after each insertion round, and the cap of the final
# cleanup's sub-rounds (build_2d's defaults in the JAX package).
FLIPS_PER_ROUND = 2
MAX_FLIP_ROUNDS = 4096
# A matching executes at most max(R // RF_DIV, 64) flips; the rest stay
# candidates for the next sub-round.
RF_DIV = 4
# Past this many sites the JAX package switches to its chunked, seeded
# build, which is not ported yet.
CHUNK_THRESHOLD = 400_000


class BuildState(NamedTuple):
    """Build arrays; each holds M real slots plus the trash row M."""

    tri_v: torch.Tensor     # [M+1, 3] int32 vertex ids (-1 = unallocated)
    tri_n: torch.Tensor     # [M+1, 3] int32 neighbour ids, -1 = boundary
    cc: torch.Tensor        # [M+1, 2] float: (ok, vertex-id sum) per slot
    n_tris: torch.Tensor    # 0-d int32: allocated slots
    site_tri: torch.Tensor  # [N] int32: containing leaf per site; -1 inserted
    n_left: torch.Tensor    # 0-d int32: uninserted site count


def _slots(st_or_arr) -> int:
    """M, the number of real slots."""
    arr = st_or_arr.tri_v if isinstance(st_or_arr, BuildState) else st_or_arr
    return arr.shape[0] - 1


def _set_rows(arr, rows, vals, keep):
    """``arr`` with ``arr[rows[i]] = vals[i]`` where ``keep``; the other
    writes go to the trash row (the last)."""
    tgt = torch.where(keep, rows, arr.shape[0] - 1)
    return arr.index_put((tgt.long(),), vals)


def _argmax_first(mask):
    """Index of the first True along the last axis (0 if none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _pick(arr, idx):
    """``arr[r, idx[r]]`` for [R, k] arr and [R] idx."""
    return arr.gather(1, idx[:, None])[:, 0]


def _assign_split_child(pts, tri_v, cAB_map, t_of, q):
    """Child of a split leaf that holds each site: sector tests around the
    new vertex s.  The parent slot P = (s, v1, v2), cA = (s, v2, v0),
    cB = (s, v0, v1); ties (q on a ray) go to A, then B, else P."""
    ab = cAB_map[t_of]  # [B, 2]
    A, B = ab[:, 0], ab[:, 1]
    tv2 = tri_v[torch.stack([t_of, A.clamp_min(0)], -1)]  # [B, 2, 3]
    pid4 = torch.stack(
        [tv2[:, 0, 0], tv2[:, 1, 2], tv2[:, 0, 1], tv2[:, 0, 2]], -1
    )  # (s, v0, v1, v2)
    p4 = pts[pid4]  # [B, 4, 2]
    s_pt, v0_pt, v1_pt, v2_pt = p4[:, 0], p4[:, 1], p4[:, 2], p4[:, 3]
    a0 = robust.orient2d_ds(s_pt, v0_pt, q)
    a1 = robust.orient2d_ds(s_pt, v1_pt, q)
    a2 = robust.orient2d_ds(s_pt, v2_pt, q)
    # A clockwise parent flips every sector test.
    D = robust.orient2d_ds(s_pt, v1_pt, v2_pt)
    o = torch.where(D < 0, -1.0, 1.0).to(a0.dtype)
    b0, b1, b2 = a0 * o, a1 * o, a2 * o
    in_A = (b2 >= 0) & (b0 < 0)
    in_B = (b0 >= 0) & (b1 < 0)
    return torch.where(in_A, A, torch.where(in_B, B, t_of))


def _assign_flip_side(pts, tri_v, flip_info, t_of, q):
    """Side of the new diagonal (e, c) of an executed flip that holds each
    site: rows of a flipped pair hold the diagonal in slots (0, 1).
    On-diagonal ties and degenerate apexes keep t."""
    info = flip_info[t_of]  # [B, 3]: (partner, own apex, partner apex)
    us = info[:, 0].clamp_min(0)
    tvt = tri_v[t_of]  # (e, c, own apex)
    pid4 = torch.stack(
        [tvt[:, 0], tvt[:, 1], info[:, 1], info[:, 2].clamp_min(0)], -1
    )
    p4 = pts[pid4.clamp_min(0)]  # [B, 4, 2]
    e_pt, c_pt, at_pt, au_pt = p4[:, 0], p4[:, 1], p4[:, 2], p4[:, 3]
    dq = robust.orient2d_ds(e_pt, c_pt, q)
    dt = robust.orient2d_ds(e_pt, c_pt, at_pt)
    du = robust.orient2d_ds(e_pt, c_pt, au_pt)
    take_u = (dq * du > 0) & ~(dq * dt > 0)
    return torch.where(take_u, us, t_of)


def _cc_update(cc, pts, tri_v, rows, rows_valid):
    """Refresh the (ok, vertex-id sum) cache of the given rows.

    ``ok`` marks a non-degenerate triangle (compensated orientation != 0,
    the condition under which the reference's circumcircle solve is
    singular, linear_simplex.c:517-521).  The id sum is exact in float32
    for sums below 2^24; the flip pass gets each neighbour's far vertex as
    ``vsum(u) - shared_a - shared_b``.
    """
    safe = torch.where(rows_valid, rows, 0)
    tv_rows = tri_v[safe]
    verts = pts[tv_rows]  # [K, 3, 2]
    D = robust.orient2d_ds(verts[:, 0], verts[:, 1], verts[:, 2])
    ok = (D != 0).to(cc.dtype)
    vsum = torch.sum(tv_rows, dim=-1).to(cc.dtype)
    return _set_rows(cc, rows, torch.stack([ok, vsum], -1), rows_valid)


def _init_state(pts, N: int) -> BuildState:
    """The cage triangle in slot 0 and every site in it; 2N + 3 slots, the
    exact need."""
    M = 2 * N + 3
    dev = pts.device
    tri_v = torch.full((M + 1, 3), -1, dtype=I32, device=dev)
    tri_v[0] = torch.arange(3, dtype=I32, device=dev)
    tri_n = torch.full((M + 1, 3), -1, dtype=I32, device=dev)
    cc = torch.zeros((M + 1, 2), dtype=pts.dtype, device=dev)
    zero = torch.zeros(1, dtype=I32, device=dev)
    cc = _cc_update(
        cc, pts, tri_v, zero, torch.ones(1, dtype=torch.bool, device=dev)
    )
    return BuildState(
        tri_v=tri_v,
        tri_n=tri_n,
        cc=cc,
        n_tris=torch.tensor(1, dtype=I32, device=dev),
        site_tri=torch.zeros(N, dtype=I32, device=dev),
        n_left=torch.tensor(N, dtype=I32, device=dev),
    )


def _owner_of_face(tri_v, cands, a, b):
    """Among candidate triangle ids [..., C], the first holding both verts
    a and b (shapes [...]); else the first candidate."""
    cv = tri_v[cands]  # [..., C, 3]
    has_a = torch.any(cv == a[..., None, None], dim=-1)
    has_b = torch.any(cv == b[..., None, None], dim=-1)
    okc = has_a & has_b & (cands >= 0)
    idx = _argmax_first(okc)
    found = torch.any(okc, dim=-1)
    owner = cands.gather(-1, idx[..., None])[..., 0]
    return torch.where(found, owner, cands[..., 0])


def _repair_after_split(tri_v, tri_n, split_flag, cA, cB):
    """Re-resolve neighbour ids that point at triangles that just split."""
    M = split_flag.shape[0]
    tv, tn = tri_v[:M], tri_n[:M]
    cols = []
    for m in range(3):
        n = tn[:, m]
        stale = (n >= 0) & split_flag[torch.where(n >= 0, n, 0)]
        ns = torch.where(stale, n, 0)
        a = tv[:, (m + 1) % 3]
        b = tv[:, (m + 2) % 3]
        cands = torch.stack([ns, cA[ns], cB[ns]], -1)
        owner = _owner_of_face(tv, cands, a, b)
        cols.append(torch.where(stale, owner, n))
    return torch.cat([torch.stack(cols, -1), tri_n[M:]])


def _split_round(pts, st: BuildState) -> BuildState:
    """One parallel insertion round."""
    M = _slots(st)
    N = st.site_tri.shape[0]
    dev = pts.device
    site_ids = torch.arange(N, dtype=I32, device=dev)
    tri_v, tri_n, cc, n_tris, site_tri, n_left = st
    # 1. Each leaf claims its lowest-id uninserted site.
    tgt = torch.where(site_tri >= 0, site_tri, M)  # inserted -> trash
    claim = torch.full((M + 1,), INT_MAX, dtype=I32, device=dev)
    claim = claim.scatter_reduce(
        0, tgt.long(), site_ids, "amin", include_self=True
    )[:M]
    has = claim != INT_MAX  # [M] triangles splitting this round
    # 2. Child slots by prefix rank, capped by the capacity (with
    # M = 2N + 3 the cap never binds).
    rank = torch.cumsum(has.to(I32), 0, dtype=I32) - 1
    has = has & (n_tris + 2 * (rank + 1) <= M)
    cA = torch.where(has, n_tris + 2 * rank, -1).to(I32)
    cB = torch.where(has, n_tris + 2 * rank + 1, -1).to(I32)
    n_new = torch.sum(has, dtype=I32)

    p = torch.arange(M, dtype=I32, device=dev)
    s_pid = claim + 3  # point id of the claimed site
    v0, v1, v2 = tri_v[:M, 0], tri_v[:M, 1], tri_v[:M, 2]
    n0, n1, n2 = tri_n[:M, 0], tri_n[:M, 1], tri_n[:M, 2]

    def scat(arr, rows, *cols):
        return _set_rows(arr, rows, torch.stack(cols, -1), has)

    # The child in the parent slot keeps face 0 (old n0); cA gets n1, cB n2.
    tri_v = scat(tri_v, p, s_pid, v1, v2)
    tri_n = scat(tri_n, p, n0, cA, cB)
    tri_v = scat(tri_v, cA, s_pid, v2, v0)
    tri_n = scat(tri_n, cA, n1, cB, p)
    tri_v = scat(tri_v, cB, s_pid, v0, v1)
    tri_n = scat(tri_n, cB, n2, p, cA)
    n_tris = n_tris + 2 * n_new

    # 3. Neighbours that split: the face owner is now whichever of
    # (parent, cA, cB) holds both shared-face vertices.
    tri_n = _repair_after_split(tri_v, tri_n, has, cA, cB)
    cc = _cc_update(
        cc, pts, tri_v, torch.cat([p, cA, cB]), torch.cat([has] * 3)
    )

    # 4. Re-locate uninserted sites whose leaf split; retire the claimed.
    t_of = torch.where(site_tri >= 0, site_tri, 0)
    needs = (site_tri >= 0) & has[t_of]
    q = pts[site_ids + 3]
    new_tri = _assign_split_child(
        pts, tri_v, torch.stack([cA, cB], -1), torch.where(needs, t_of, 0), q
    )
    site_tri = torch.where(needs, new_tri, site_tri)
    claimed = (site_tri >= 0) & (claim[t_of] == site_ids) & has[t_of]
    site_tri = torch.where(claimed, -1, site_tri)
    n_left = n_left - torch.sum(claimed, dtype=I32)
    return BuildState(tri_v, tri_n, cc, n_tris, site_tri, n_left)


def _edge_candidate_inputs(pts, tri_v, tri_n, cc, rows, rvalid):
    """Gathers of the flip-candidate pass: ``(tv, tn, args)``, where
    ``args`` is the argument tuple of ``candmath.edge_candidates_math``."""
    rs = torch.where(rvalid, rows, 0)
    tv = tri_v[rs]  # [R, 3]
    tn = tri_n[rs]
    alive = rvalid & (tv[:, 0] >= 0)
    cok = cc[rs][:, 0] > 0.5
    valid3 = alive[:, None] & (tn >= 0)
    uu3 = torch.where(valid3, tn, 0)
    # The neighbour's cache row gives its far vertex: vsum - the two
    # shared ids.
    ccu = cc[uu3]  # [R, 3, 2]
    degen_u = ~(ccu[..., 0] > 0.5)
    p1_id = torch.roll(tv, -1, dims=1)
    p2_id = torch.roll(tv, -2, dims=1)
    far3 = ccu[..., 1].to(I32) - p1_id - p2_id
    far3 = far3.clamp(0, pts.shape[0] - 1)  # garbage rows are masked
    p6 = pts[torch.cat([tv, far3], dim=1)]  # [R, 6, 2]: apexes, far points
    apex3, fq3 = p6[:, :3], p6[:, 3:]
    return tv, tn, (apex3, fq3, tv, p1_id, far3, p2_id, valid3, cok, degen_u)


def _edge_candidates(pts, tri_v, tri_n, cc, rows, rvalid):
    """``(tv, tn, cand_ok [R, 3])``: the canonical flip-candidate mask for
    the 3 edges of the listed rows.  The verdict runs in the CUDA kernel
    for CUDA tensors (``ops/candmath.py``)."""
    tv, tn, args = _edge_candidate_inputs(pts, tri_v, tri_n, cc, rows, rvalid)
    return tv, tn, candmath.edge_candidates_math(*args)


def _match_and_flip(
    pts, tri_v, tri_n, cc, rows, rvalid, tv, tn, cand_ok
):
    """Mutual-minimum matching and in-place execution of the matched flips.

    Each row picks its smallest candidate partner; mutual picks flip, and
    a pick whose partner is outside the processed rows flips on its own,
    arbitrated by a scatter-min claim.  At most ``max(R // RF_DIV, 64)``
    flips run per call; the rest stay candidates.  Neighbour repair is
    integrated: the pair's outward pointers resolve through the round's
    flip map, and the two outer rows whose pointer into the pair goes stale
    get a single-element fix.

    Returns ``(tri_v, tri_n, cc, flip_info [M+1, 3], any_flip)``;
    ``flip_info`` holds (partner, own apex, partner apex) for each executed
    row, -1 elsewhere.  (The JAX version also returns the rewritten rows and
    the executed count, which only its chunked route reads.)
    """
    M = _slots(tri_v)
    dev = tri_v.device
    rs = torch.where(rvalid, rows, 0)
    partner_cand = torch.where(cand_ok, tn, INT_MAX)
    pick = torch.amin(partner_cand, dim=-1)  # [R] best partner or INT_MAX
    pick_ok = pick != INT_MAX
    pick_safe = torch.where(pick_ok, pick, 0)
    pick_g = torch.full((M + 1,), INT_MAX, dtype=I32, device=dev)
    pick_g = _set_rows(pick_g, rows, pick, rvalid)
    mutual = pick_ok & (pick_g[pick_safe] == rs) & (pick_safe != rs)
    # A partner outside the processed rows reads INT_MAX: flip on our own,
    # arbitrated so two rows never rewrite the same absent row.
    absent = pick_ok & (pick_g[pick_safe] == INT_MAX) & (pick_safe != rs)
    claim_g = torch.full((M + 1,), INT_MAX, dtype=I32, device=dev)
    claim_g = claim_g.scatter_reduce(
        0, torch.where(absent, pick_safe, M).long(), rs, "amin",
        include_self=True,
    )
    won = absent & (claim_g[pick_safe] == rs)
    # Each mutual edge runs once, from the lower id.
    do = (mutual & (rs < pick_safe)) | won
    R = do.shape[0]
    Rf = max(R // RF_DIV, 64)
    frank = torch.cumsum(do.to(I32), 0, dtype=I32) - 1
    do = do & (frank < Rf)
    any_flip = torch.any(do)

    fidx = torch.full((Rf + 1,), -1, dtype=I32, device=dev)
    fidx = fidx.index_put(
        (torch.where(do, frank, Rf).long(),),
        torch.arange(R, dtype=I32, device=dev),
    )[:Rf]
    fvalid = fidx >= 0
    fs = torch.where(fvalid, fidx, 0)
    ts = torch.where(fvalid, rs[fs], 0)         # [Rf] lower-id triangle
    us = torch.where(fvalid, pick_safe[fs], 0)  # [Rf] its partner
    tvf = tv[fs]
    tnf = tn[fs]

    # Slots: k in t facing u; j in u facing t.
    uvv = tri_v[us]  # [Rf, 3]
    unn = tri_n[us]
    k_slot = _argmax_first(tnf == us[:, None])
    j_slot = _argmax_first(unn == ts[:, None])
    c = _pick(tvf, k_slot)
    e = _pick(uvv, j_slot)
    # t's other verts and neighbours: p at k+1, q at k+2.
    pv = _pick(tvf, (k_slot + 1) % 3)
    qv = _pick(tvf, (k_slot + 2) % 3)
    Np = _pick(tnf, (k_slot + 1) % 3)
    Nq = _pick(tnf, (k_slot + 2) % 3)
    # u's neighbours across faces {e, q} and {e, p}: match by vertex.
    Up = _pick(unn, _argmax_first(uvv == pv[:, None]))
    Uq = _pick(unn, _argmax_first(uvv == qv[:, None]))

    # T1 = (e, c, q): face {c, q} -> Np, face {e, q} -> Up, slot 2 -> u.
    # T2 = (e, c, p): face {c, p} -> Nq, face {e, p} -> Uq, slot 2 -> t.
    rows_tu = torch.cat([ts, us])
    valid_tu = torch.cat([fvalid, fvalid])
    new_tv = _set_rows(
        tri_v,
        rows_tu,
        torch.cat([torch.stack([e, c, qv], -1), torch.stack([e, c, pv], -1)]),
        valid_tu,
    )
    # The executed-flip map, built before the tri_n write: the pair's
    # outward pointers may name rows that flipped in this same round.
    flip_info = torch.full((M + 1, 3), -1, dtype=I32, device=dev)
    flip_info = _set_rows(
        flip_info,
        rows_tu,
        torch.cat(
            [torch.stack([us, qv, pv], -1), torch.stack([ts, pv, qv], -1)]
        ),
        valid_tu,
    )
    # Pointer v with face (a, b) belongs to v's partner when the face holds
    # the partner's apex, else to v itself.
    out_ids = torch.cat([Np, Up, Nq, Uq])  # [4Rf]
    info4 = flip_info[torch.where(out_ids >= 0, out_ids, 0)]
    fa4 = torch.cat([c, e, c, e])
    fb4 = torch.cat([qv, qv, pv, pv])
    partner4, ap_par4 = info4[:, 0], info4[:, 2]
    hit_par = (fa4 == ap_par4) | (fb4 == ap_par4)
    res4 = torch.where(
        (out_ids >= 0) & (partner4 >= 0) & hit_par, partner4, out_ids
    )
    F = Np.shape[0]
    Np_r, Up_r, Nq_r, Uq_r = res4.split(F)
    new_tn = _set_rows(
        tri_n,
        rows_tu,
        torch.cat(
            [torch.stack([Np_r, Up_r, us], -1),
             torch.stack([Nq_r, Uq_r, ts], -1)]
        ),
        valid_tu,
    )
    # Incoming fixes: an unflipped Up now points at ts (held us), an
    # unflipped Nq at us (held ts).  The (row, slot) targets are distinct.
    x2 = torch.cat([Up, Nq])
    old2 = torch.cat([us, ts])
    new2 = torch.cat([ts, us])
    x_flipped = torch.cat(partner4.split(F)[1:3]) >= 0
    ok2 = valid_tu & (x2 >= 0) & ~x_flipped
    xrows = new_tn[torch.where(ok2, x2, 0)]  # [2Rf, 3]
    is_old = xrows == old2[:, None]
    slot2 = _argmax_first(is_old).to(I32)
    flat2 = torch.where(
        ok2 & torch.any(is_old, dim=-1), x2 * 3 + slot2, 3 * M + 1
    )  # 3M + 1 lies in the trash row
    new_tn = new_tn.reshape(-1).index_put((flat2.long(),), new2)
    new_tn = new_tn.reshape(M + 1, 3)

    # Refresh the cache of the rewritten pairs from their four points, in
    # the operand order of _cc_update.
    pid4 = torch.stack([e, c, qv, pv], -1)
    p4 = pts[pid4.clamp(0, pts.shape[0] - 1)]
    e_pt, c_pt, q_pt, p_pt = p4[:, 0], p4[:, 1], p4[:, 2], p4[:, 3]
    D1 = robust.orient2d_ds(e_pt, c_pt, q_pt)
    D2 = robust.orient2d_ds(e_pt, c_pt, p_pt)
    dt = cc.dtype
    cc = _set_rows(
        cc,
        rows_tu,
        torch.cat(
            [
                torch.stack([(D1 != 0).to(dt), (e + c + qv).to(dt)], -1),
                torch.stack([(D2 != 0).to(dt), (e + c + pv).to(dt)], -1),
            ]
        ),
        valid_tu,
    )
    return new_tv, new_tn, cc, flip_info, any_flip


def _flip_round(pts, st: BuildState, relocate: bool = True):
    """One flip sub-round over all slots: ``(state, any_flip)``."""
    M = _slots(st)
    N = st.site_tri.shape[0]
    dev = pts.device
    rows = torch.arange(M, dtype=I32, device=dev)
    rvalid = torch.ones(M, dtype=torch.bool, device=dev)
    tv, tn, cand_ok = _edge_candidates(
        pts, st.tri_v, st.tri_n, st.cc, rows, rvalid
    )
    new_tv, new_tn, cc, flip_info, any_flip = _match_and_flip(
        pts, st.tri_v, st.tri_n, st.cc, rows, rvalid, tv, tn, cand_ok
    )
    site_tri = st.site_tri
    if relocate:
        # Sites straddling an executed flip (the insert phase only; the
        # final cleanup runs with every site inserted).
        site_ids = torch.arange(N, dtype=I32, device=dev)
        t_of = torch.where(site_tri >= 0, site_tri, 0)
        in_flipped = (site_tri >= 0) & (flip_info[t_of][:, 0] >= 0)
        q = pts[site_ids + 3]
        new_t = _assign_flip_side(
            pts, new_tv, flip_info, torch.where(in_flipped, t_of, 0), q
        )
        site_tri = torch.where(in_flipped, new_t, site_tri)
    st = BuildState(new_tv, new_tn, cc, st.n_tris, site_tri, st.n_left)
    return st, any_flip


def _flip_rounds(pts, st: BuildState, cap: int, relocate: bool = True):
    """Up to ``cap`` flip sub-rounds, until one flips nothing; returns
    ``(state, sub-rounds run)``.  Reads ``any_flip`` once per sub-round."""
    it = 0
    changed = True
    while changed and it < cap:
        st, any_flip = _flip_round(pts, st, relocate=relocate)
        changed = bool(any_flip)
        it += 1
    return st, it


def build_2d(sites_std, cage_std, stats: dict | None = None):
    """Delaunay triangulation of cage + sites on the sites' device.

    Args:
      sites_std: [N, 2] standardized site coordinates, insertion-shuffled.
      cage_std: [3, 2] standardized cage vertices.
      stats: if given, receives the numbers of insertion rounds,
        insert-phase flip sub-rounds and cleanup sub-rounds.

    Returns:
      (tri_v [M, 3], tri_n [M, 3], alive [M], n_tris) with M = 2N + 3
      slots; ``alive`` marks the leaves.  Ids: 0..2 cage, 3.. sites.
    """
    pts = torch.cat([cage_std.to(sites_std.dtype), sites_std])  # [N+3, 2]
    st = _init_state(pts, sites_std.shape[0])
    rounds = sub = 0
    while int(st.n_left) > 0:  # one host read per round
        st = _split_round(pts, st)
        # A bounded number of flip sub-rounds per insertion round: the
        # intermediate states may be locally non-Delaunay, which location
        # and splits do not need.
        st, it = _flip_rounds(pts, st, FLIPS_PER_ROUND)
        rounds += 1
        sub += it
    # Final cleanup: flip to convergence (all sites inserted).
    st, cleanup = _flip_rounds(pts, st, MAX_FLIP_ROUNDS, relocate=False)
    if stats is not None:
        stats.update(rounds=rounds, insert_sub_rounds=sub,
                     cleanup_sub_rounds=cleanup)
    M = _slots(st)
    tri_v, tri_n = st.tri_v[:M], st.tri_n[:M]
    return tri_v, tri_n, tri_v[:, 0] >= 0, st.n_tris


def build_inputs(sites_raw, lo=None, hi=None, flags: int = 0, key=None,
                 dtype=torch.float64):
    """What the build starts from, all on the host: ``(shift, scale,
    shuffle, cage_raw, cage_std, sites_std)``.

    ``cage_raw`` [3, 2] is in ``dtype``'s numpy type, ``cage_std`` a
    ``dtype`` tensor, ``sites_std`` [n, 2] float64 numpy: the sites
    shuffled, standardized and jittered by 8 ulps of ``dtype`` drawn from
    ``np.random.default_rng(12345)``.  The jitter is a deterministic
    symbolic perturbation for the build's predicates: exactly degenerate
    input (collinear runs, cocircular lattices) breaks the parallel flip
    schedule's tie handling.  It is kept small, since it displaces the
    triangulation from the exact points.
    """
    sites_raw = np.asarray(sites_raw, np.float64)
    n, d = sites_raw.shape
    if flags & host_tree.NOSTANDARDIZE:
        lo_, hi_ = np.full(d, -0.5), np.full(d, 0.5)
    else:
        lo_ = sites_raw.min(0) if lo is None else np.asarray(lo, np.float64)
        hi_ = sites_raw.max(0) if hi is None else np.asarray(hi, np.float64)
    shift = (lo_ + hi_) / 2.0
    ext = hi_ - lo_
    scale = np.where(ext > 0, 1.0 / np.where(ext > 0, ext, 1.0), 1.0)
    if (flags & host_tree.ISOSCALE) and not (flags & host_tree.NOSTANDARDIZE):
        scale = np.full(d, scale.min())

    shuffle = rng_util.insertion_shuffle(key, n)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    cage_raw = geometry.cage_vertices(d, shift, scale, np_dtype.type)
    cage_std = torch.as_tensor(scale * (cage_raw - shift), dtype=dtype)
    sites_std = sites_raw[shuffle]
    sites_std -= shift
    sites_std *= scale
    jit_mag = 8.0 * machine.eps(dtype)
    sites_std += jit_mag * np.random.default_rng(12345).uniform(-1, 1, (n, d))
    return shift, scale, shuffle, cage_raw, cage_std, sites_std


def triangulate(
    sites_raw,
    lo=None,
    hi=None,
    flags: int = 0,
    key=None,
    dtype=torch.float64,
    grid_res: int = 256,
    device="cuda",
    stats: dict | None = None,
):
    """End to end: standardize, cage, shuffle, build on ``device``, freeze.

    The device analog of ``simplex_tree_init`` (linear_simplex.c:134-296)
    for d = 2.  Returns a float64 DeviceTriangulation on ``device`` and the
    shuffle permutation: the response of data row i is user row
    ``shuffle[i]`` (:func:`device_tri.response_for_build`).  Flags are
    host_tree's DEFAULT / NOSTANDARDIZE / ISOSCALE.  ``dtype`` is the
    precision of the build's predicates.
    """
    sites_raw = np.asarray(sites_raw, np.float64)
    n, d = sites_raw.shape
    if d != 2:
        raise NotImplementedError(
            "the device build is 2D; use models.host_tree for general d"
        )
    if n > CHUNK_THRESHOLD:
        raise NotImplementedError(
            f"{n} sites exceed the single-program build's {CHUNK_THRESHOLD}; "
            "the chunked and seeded build comes with ROADMAP Queue A item 6"
        )
    if 3 * (n + 3) >= 2**24:
        # The cache's vertex-id sums must stay exact in float32.
        raise NotImplementedError(
            f"{n} sites: the vertex-id sums would be inexact in float32"
        )
    shift, scale, shuffle, cage_raw, cage_std, sites_std = build_inputs(
        sites_raw, lo, hi, flags, key, dtype
    )
    tri_v, tri_n, alive, _ = build_2d(
        torch.as_tensor(sites_std, dtype=dtype, device=device),
        cage_std.to(device),
        stats=stats,
    )
    points_raw = np.concatenate([cage_raw, sites_raw[shuffle]])
    tri = device_tri.from_arrays(
        points_raw, shift, scale, tri_v, tri_n, alive, grid_res=grid_res,
        device=device,
    )
    return tri, shuffle
