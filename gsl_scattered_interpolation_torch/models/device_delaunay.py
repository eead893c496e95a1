"""Device 2D Delaunay build: batched insertion rounds plus parallel flips.

The 2D device build of ``gsl_scattered_interpolation_tpu/models/
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

Two routes.  Up to ``CHUNK_THRESHOLD`` sites, :func:`build_2d` runs the
rounds over all M slots.  Past it, :func:`build_2d_chunked` seeds from a
Qhull triangulation of the first sites (:func:`_seed_state_2d`) and runs
the rounds on [R]-compacted workspaces (:func:`_split_round_compact`,
:func:`_flip_sweep_compact`), so a round costs O(R + activity).

Point ids: 0..2 are the cage vertices, 3..N+2 the sites in insertion order.

Differences from the JAX package:
  * every state array has one spare "trash" row after its M real slots;
    writes that JAX drops (``mode="drop"`` at row M+1) go there, so a
    scatter needs no mask and no host sync.  Real target rows stay
    distinct, as in JAX; only the trash row takes duplicates;
  * the ``while_loop``s are Python loops that read ``n_left``,
    ``any_flip`` or a dirty count from the device once per round;
  * no shape bucketing: the TPU's compile-cache padding changes no row of
    the result, because pad sites never claim and slots are allocated by
    prefix rank from ``n_tris``;
  * the chunked route has no dispatch batching (``k_batch``,
    ``sweep_rounds``), no capacity staging and no AOT cache: those kept
    TPU executions short and compiles cached.
"""

from __future__ import annotations

import logging
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops import candmath, geometry, robust
from ..utils import machine, profiling
from ..utils import rng as rng_util
from . import device_tri, host_tree

log = logging.getLogger(__name__)

INT_MAX = 2**31 - 1
I32 = torch.int32
# Flip sub-rounds after each insertion round, and the cap of the final
# cleanup's sub-rounds (build_2d's defaults in the JAX package).
FLIPS_PER_ROUND = 2
MAX_FLIP_ROUNDS = 4096
# A matching executes at most max(R // rf_div, 64) flips; the rest stay
# candidates for the next sub-round.  The insert phase uses RF_DIV, the
# chunked route's final sweep SWEEP_RF_DIV.
RF_DIV = 4
SWEEP_RF_DIV = 2
# Past this many sites triangulate takes the chunked route, seeded from
# Qhull from SEED_MIN sites on with the first N // SEED_FRAC sites.
CHUNK_THRESHOLD = 400_000
SEED_MIN = 200_000
SEED_FRAC = 8
# The chunked route's workspaces: split rounds per insert iteration, the
# big and the tail rung's rows, and the relocation chunk.
SPLITS_PER_ROUND = 4
R_COMPACT = 524_288
R_TAIL = 131_072
R_SITE = 1 << 21


class SeedLocateError(RuntimeError):
    """The Qhull seed's exact walk left some sites unlocated (its step or
    workspace budget ran out).  :func:`triangulate` then builds without a
    seed."""


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


def _compact_rows(mask, R: int):
    """[R] int32: the indices where ``mask`` holds, in order, then -1 (a
    prefix compaction; indices past the first R are left out)."""
    n = mask.shape[0]
    dev = mask.device
    rank = torch.cumsum(mask.to(I32), 0, dtype=I32) - 1
    sel = mask & (rank < R)
    out = torch.full((R + 1,), -1, dtype=I32, device=dev)
    out = out.index_put(
        (torch.where(sel, rank, R).long(),),
        torch.arange(n, dtype=I32, device=dev),
    )
    return out[:R]


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
    pts, tri_v, tri_n, cc, rows, rvalid, tv, tn, cand_ok,
    want_frec: bool = False, rf_div: int = RF_DIV,
):
    """Mutual-minimum matching and in-place execution of the matched flips.

    Each row picks its smallest candidate partner; mutual picks flip, and
    a pick whose partner is outside the processed rows flips on its own,
    arbitrated by a scatter-min claim.  At most ``max(R // rf_div, 64)``
    flips run per call; the rest stay candidates.  Neighbour repair is
    integrated: the pair's outward pointers resolve through the round's
    flip map, and the two outer rows whose pointer into the pair goes stale
    get a single-element fix.

    Returns ``(tri_v, tri_n, cc, flip_info [M+1, 3], rep [2Rf],
    repv [2Rf], any_flip, n_exec)``: ``flip_info`` holds (partner, own
    apex, partner apex) for each executed row, -1 elsewhere; ``rep`` are
    the rewritten rows where ``repv``; ``n_exec`` counts the executed
    flips.  With ``want_frec`` an [M+1, 6] relocation record follows: for
    each rewritten row the new diagonal's coordinates (e, c), the side of
    its own apex (+-1) and its partner's id, -1 elsewhere
    (:func:`_assign_flip_side_rec`).
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
    # The first Rf of them execute, compacted.
    Rf = max(do.shape[0] // rf_div, 64)
    any_flip = torch.any(do)
    fidx = _compact_rows(do, Rf)
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
    n_exec = torch.sum(fvalid, dtype=I32)
    out = (new_tv, new_tn, cc, flip_info, rows_tu, valid_tu, any_flip, n_exec)
    if not want_frec:
        return out
    dt = pts.dtype
    sg1 = torch.where(D1 < 0, -1.0, 1.0).to(dt)
    sg2 = torch.where(D2 < 0, -1.0, 1.0).to(dt)
    diag = torch.cat([e_pt, c_pt], -1)  # [Rf, 4]
    frec = torch.full((M + 1, 6), -1.0, dtype=dt, device=dev)
    frec = _set_rows(
        frec,
        rows_tu,
        torch.cat(
            [
                torch.cat([diag, sg1[:, None], us.to(dt)[:, None]], -1),
                torch.cat([diag, sg2[:, None], ts.to(dt)[:, None]], -1),
            ]
        ),
        valid_tu,
    )
    return (*out, frec)


def _assign_flip_side_rec(frec, t_of, q):
    """:func:`_assign_flip_side` from the relocation record: the pair's
    apexes lie strictly on opposite sides of the new diagonal, so a site
    moves to the partner iff ``orient(e, c, q)`` has the sign opposite its
    own apex's; on-diagonal ties keep t."""
    r = frec[t_of]  # [B, 6]
    e_pt, c_pt = r[:, 0:2], r[:, 2:4]
    sg, partner = r[:, 4], r[:, 5].to(I32)
    dq = robust.orient2d_ds(e_pt, c_pt, q)
    take_u = (dq * sg < 0) & (partner >= 0)
    return torch.where(take_u, partner, t_of)


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
    new_tv, new_tn, cc, flip_info, _, _, any_flip, _ = _match_and_flip(
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


# ---------------------------------------------------------------------------
# The chunked route: Qhull seed, exact walk, compacted rounds
# ---------------------------------------------------------------------------


def _pack_walk_rows(pts, tri_v, tri_n):
    """[T, 9] walk record per triangle: its vertex coordinates in
    counter-clockwise order, then the neighbour ids across the faces
    opposite them, as floats (exact below 2^24).  Swapping v1 and v2 swaps
    the faces opposite them."""
    p3 = pts[tri_v.clamp_min(0)]  # [T, 3, 2]
    o = robust.orient2d_ds(p3[:, 0], p3[:, 1], p3[:, 2])
    sw = (o < 0)[:, None]
    v1 = torch.where(sw, p3[:, 2], p3[:, 1])
    v2 = torch.where(sw, p3[:, 1], p3[:, 2])
    n1 = torch.where(sw[:, 0], tri_n[:, 2], tri_n[:, 1])
    n2 = torch.where(sw[:, 0], tri_n[:, 1], tri_n[:, 2])
    nbrs = torch.stack([tri_n[:, 0], n1, n2], -1).to(pts.dtype)
    return torch.cat([p3[:, 0], v1, v2, nbrs], -1)


def _face_orients(row, q):
    """[B, 3] compensated ``orient`` of q against the faces (v1, v2),
    (v2, v0), (v0, v1) of packed rows; all >= 0 inside."""
    v0, v1, v2 = row[:, 0:2], row[:, 2:4], row[:, 4:6]
    A = torch.stack([v1, v2, v0], 1)
    Bv = torch.stack([v2, v0, v1], 1)
    return robust.orient2d_ds(A, Bv, q[:, None, :])


def _walk_step(packed, q, cur, prev, done, step: int):
    """One visibility-walk step across the most violated face; on odd
    steps a query with two violated faces takes the second."""
    row = packed[cur]  # [B, 9]
    s3 = _face_orients(row, q)
    inside = torch.all(s3 >= 0, dim=-1)
    worst = torch.argmin(s3, dim=-1)
    if step & 1:
        faces = torch.arange(3, device=q.device)
        s2 = torch.where(faces == worst[:, None], torch.inf, s3)
        two_neg = torch.sum(s3 < 0, dim=-1) > 1
        worst = torch.where(two_neg, torch.argmin(s2, dim=-1), worst)
    nbr = _pick(row[:, 6:9], worst).to(I32)
    cycling = (nbr == prev) & ~inside
    newly_done = inside | (nbr < 0) | cycling
    advance = ~(done | newly_done)
    return (
        torch.where(advance, nbr, cur),
        torch.where(advance, cur, prev),
        done | newly_done,
    )


def _locate_walk_exact(packed, start, q, max_steps: int = 256,
                       lockstep: int = 8, tail_div: int = 16):
    """Visibility walk by the signs of the compensated predicates, so the
    final containment verdict is exact on the build's coordinates; on-edge
    queries count as contained.

    ``lockstep`` steps run at full width; then the unfinished queries are
    compacted into a workspace of ``max(B // tail_div, 256)`` rows and walk
    on to ``max_steps``.  A query that overflows the workspace or runs out
    of steps reports ``ok = False``.  The tail loop reads ``done.all()``
    once every ``device_tri.WALK_DONE_EVERY`` steps (a finished query never
    moves, so the leaves are the JAX ``while_loop``'s).

    Returns (leaf [B] int32, ok [B] bool).
    """
    B = q.shape[0]
    dev = q.device
    cur = start.to(I32)
    prev = torch.full((B,), -1, dtype=I32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for step in range(lockstep):
        cur, prev, done = _walk_step(packed, q, cur, prev, done, step)

    B2 = min(B, max(B // tail_div, 256))
    slot = _compact_rows(~done, B2)
    valid2 = slot >= 0
    sl = torch.where(valid2, slot, 0)
    q2 = q[sl]
    cur2 = torch.where(valid2, cur[sl], 0)
    prev2 = torch.where(valid2, prev[sl], -1)
    done2 = ~valid2
    step = lockstep
    while step < max_steps:
        if ((step - lockstep) % device_tri.WALK_DONE_EVERY == 0
                and bool(done2.all())):
            break
        cur2, prev2, done2 = _walk_step(packed, q2, cur2, prev2, done2, step)
        step += 1
    cur = torch.cat([cur, cur[:1]])  # row B takes the unused slots
    cur = cur.index_put((torch.where(valid2, slot, B).long(),), cur2)[:B]
    # Containment is checked for every query: a phase-1 stop at a boundary
    # or a cycle is not containment.
    return cur, torch.all(_face_orients(packed[cur], q) >= 0, dim=-1)


def _seed_state_2d(sites_std, cage_std, seed_frac: int = SEED_FRAC):
    """State of the chunked build seeded from Qhull: the exact Delaunay
    triangulation of the cage and the first ``N // seed_frac`` sites, with
    every other site located in it.

    Without a seed the first rounds insert few sites (each leaf claims
    one); the seed starts the rounds with ~2N/seed_frac leaves.  scipy's
    Qhull triangulates the sites rounded to the build's dtype, so its
    triangulation is Delaunay for the build's predicates too.  The other
    sites are located on the device by :func:`_locate_walk_exact`, started
    from a grid of triangles incident to the nearest seed site.  Sites
    Qhull merged away (coplanar) are located and inserted like the rest.
    A float64 seed starts dirty: the 8-ulp jitter lies inside Qhull's
    merge tolerance, so the first sweep re-checks every seed triangle.  A
    float32 seed starts clean.

    Args:
      sites_std: [N, 2] float64 numpy, standardized and jittered.
      cage_std: [3, 2] tensor in the build's dtype on the build's device.

    Returns ``(pts, BuildState, dirty)``, or None when the seed would hold
    fewer than 32 sites or scipy is missing.  Raises
    :class:`SeedLocateError` when the walk leaves a site unlocated.
    """
    try:
        from scipy.spatial import Delaunay
    except ImportError:
        return None
    N = sites_std.shape[0]
    m = N // seed_frac
    if m < 32:
        return None
    # The walk-start grid: about one seed site per 2 cells.
    grid_res = 1 << int(np.ceil(np.log2(max(np.sqrt(2.0 * m), 16))))
    dtype = cage_std.dtype
    dev = cage_std.device
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    M = 2 * N + 3
    rounded = sites_std[:m].astype(np_dtype).astype(np.float64)
    cage_r = cage_std.cpu().numpy().astype(np.float64)
    p = np.concatenate([cage_r, rounded])
    sd = Delaunay(p)
    tv0 = np.asarray(sd.simplices, np.int32)  # point ids are the build's
    tn0 = np.asarray(sd.neighbors, np.int32)
    T0 = tv0.shape[0]
    pa, pb, pc = p[tv0[:, 0]], p[tv0[:, 1]], p[tv0[:, 2]]
    det = (pb[:, 0] - pa[:, 0]) * (pc[:, 1] - pa[:, 1]) - (
        pb[:, 1] - pa[:, 1]
    ) * (pc[:, 0] - pa[:, 0])
    cc0 = np.stack([det != 0, tv0.sum(1)], -1).astype(np_dtype)
    inserted = np.zeros(N, bool)
    inserted[:m] = True
    if len(sd.coplanar):
        cop = sd.coplanar[:, 0] - 3  # input ids -> site ids
        inserted[cop[(cop >= 0) & (cop < m)]] = False
    n_left = int((~inserted).sum())

    # Walk starts: a triangle incident to the seed site in each grid cell
    # (the last one written wins), the empty cells filled from their
    # neighbours.
    v2s = np.asarray(sd.vertex_to_simplex, np.int32)[3:]
    cells = np.clip(
        ((rounded + 0.5) * grid_res).astype(np.int64), 0, grid_res - 1
    )
    g = np.full(grid_res * grid_res, -1, np.int32)
    g[cells[:, 0] * grid_res + cells[:, 1]] = v2s
    g = g.reshape(grid_res, grid_res)
    while (g < 0).any():
        for ax in (0, 1):
            for s in (1, -1):
                cand = np.roll(g, s, axis=ax)
                if ax == 0:
                    cand[0 if s == 1 else -1, :] = -1
                else:
                    cand[:, 0 if s == 1 else -1] = -1
                g = np.where(g < 0, cand, g)

    pts = torch.cat(
        [cage_std, torch.as_tensor(sites_std, dtype=dtype, device=dev)]
    )
    q = pts[3:]
    qc = ((q + 0.5) * grid_res).to(I32).clamp(0, grid_res - 1)
    grid = torch.as_tensor(g.reshape(-1), device=dev)
    start = grid[(qc[:, 0] * grid_res + qc[:, 1]).long()]
    tv0_t = torch.as_tensor(tv0, device=dev)
    tn0_t = torch.as_tensor(tn0, device=dev)
    loc, ok = _locate_walk_exact(_pack_walk_rows(pts, tv0_t, tn0_t), start, q)
    ins = torch.as_tensor(inserted, device=dev)
    n_bad = int(torch.sum(~ok & ~ins))
    if n_bad:
        raise SeedLocateError(f"the seed's walk left {n_bad} sites unlocated")

    tri_v = torch.full((M + 1, 3), -1, dtype=I32, device=dev)
    tri_v[:T0] = tv0_t
    tri_n = torch.full((M + 1, 3), -1, dtype=I32, device=dev)
    tri_n[:T0] = tn0_t
    cc = torch.zeros((M + 1, 2), dtype=dtype, device=dev)
    cc[:T0] = torch.as_tensor(cc0, device=dev)
    if dtype == torch.float64:
        dirty = torch.arange(M + 1, device=dev) < T0
    else:
        dirty = torch.zeros(M + 1, dtype=torch.bool, device=dev)
    st = BuildState(
        tri_v=tri_v,
        tri_n=tri_n,
        cc=cc,
        n_tris=torch.tensor(T0, dtype=I32, device=dev),
        site_tri=torch.where(ins, -1, loc),
        n_left=torch.tensor(n_left, dtype=I32, device=dev),
    )
    log.info("build: qhull seed of %d sites, %d triangles, %d left to insert",
             m, T0, n_left)
    return pts, st, dirty


def _relocate_sites_chunked(pts, site_tri, affected, decide, r_site: int):
    """Re-locate the affected sites: ``decide(t_of [B], q [B, 2]) -> [B]``
    maps a site's stale triangle to its new one.

    One host read of the affected count; then ``decide`` runs on the
    affected sites only, compacted, ``r_site`` at a time.  ``decide`` is per
    site, so this gives the ``site_tri`` of each of the JAX package's
    routes (its ``lax.cond`` between all N sites and the compacted ones,
    and its chunk loop).
    """
    cnt = int(torch.sum(affected))
    ids = _compact_rows(affected, cnt)
    for s in range(0, cnt, r_site):
        sb = ids[s : s + r_site]
        new_t = decide(site_tri[sb], pts[sb + 3])
        site_tri = site_tri.index_put((sb.long(),), new_t)
    return site_tri


def _assign_split_child_rec(rec_f, t_of, q):
    """:func:`_assign_split_child` from the split record: the four vertex
    coordinates (s, v0, v1, v2), the parent's orientation sign and the two
    fresh child ids (floats, exact below 2^24) in one [B, 11] row."""
    r = rec_f[t_of]
    s_pt, v0_pt = r[:, 0:2], r[:, 2:4]
    v1_pt, v2_pt = r[:, 4:6], r[:, 6:8]
    o = r[:, 8]
    A = r[:, 9].to(I32)
    B = r[:, 10].to(I32)
    a0 = robust.orient2d_ds(s_pt, v0_pt, q)
    a1 = robust.orient2d_ds(s_pt, v1_pt, q)
    a2 = robust.orient2d_ds(s_pt, v2_pt, q)
    b0, b1, b2 = a0 * o, a1 * o, a2 * o
    in_A = (b2 >= 0) & (b0 < 0)
    in_B = (b0 >= 0) & (b1 < 0)
    return torch.where(in_A & (A >= 0), A,
                       torch.where(in_B & (B >= 0), B, t_of))


def _split_round_compact(pts, st: BuildState, dirty, R: int, r_site: int):
    """Insertion round on an [R]-compacted workspace.

    The claims and relocation decisions of :func:`_split_round`, at O(R)
    cost beyond the claim scatter: the two fresh children of split i get
    slots ``n_tris + 2i`` and ``n_tris + 2i + 1``; each child's outer
    pointer is resolved against the round's split records before it is
    written, so no repair pass runs; a non-split neighbour's one stale
    slot gets a single-element write; the children's cache rows come from
    the round's own orientation predicates; sites relocate through one
    [., 11] record row each (:func:`_assign_split_child_rec`).

    Claims past R or past the capacity wait for a later round.  Needs
    ``2R < M``.  Returns ``(state, dirty, n_new)``: the children and the
    parent slots are marked dirty for the flip sweep.
    """
    M = _slots(st)
    if 2 * R >= M:
        raise ValueError(f"_split_round_compact needs 2R < M ({R=}, {M=})")
    N = st.site_tri.shape[0]
    dev = pts.device
    dtype = pts.dtype
    site_ids = torch.arange(N, dtype=I32, device=dev)
    tri_v, tri_n, cc, n_tris, site_tri, n_left = st

    # 1. Each leaf claims its lowest-id uninserted site; the first R
    # claims that fit the capacity split.
    tgt = torch.where(site_tri >= 0, site_tri, M)
    claim = torch.full((M + 1,), INT_MAX, dtype=I32, device=dev)
    claim = claim.scatter_reduce(
        0, tgt.long(), site_ids, "amin", include_self=True
    )[:M]
    has = claim != INT_MAX
    rank = torch.cumsum(has.to(I32), 0, dtype=I32) - 1
    has = has & (n_tris + 2 * (rank + 1) <= M) & (rank < R)

    # 2. The splitting rows, compacted (a prefix of the ranks).
    prow = _compact_rows(has, R)
    pvalid = prow >= 0
    ps = torch.where(pvalid, prow, 0)
    i_r = torch.arange(R, dtype=I32, device=dev)
    ca = torch.where(pvalid, n_tris + 2 * i_r, -1)
    cb = torch.where(pvalid, n_tris + 2 * i_r + 1, -1)
    s_pid = torch.where(pvalid, claim[ps], -3) + 3  # claimed site's point id
    tvr, tnr = tri_v[ps], tri_n[ps]
    v0, v1, v2 = tvr[:, 0], tvr[:, 1], tvr[:, 2]
    n0, n1, n2 = tnr[:, 0], tnr[:, 1], tnr[:, 2]
    n_new = torch.sum(pvalid, dtype=I32)

    # 3. Split records: (v0, v1, cA, cB) per split parent.
    srec = torch.full((M + 1, 4), -1, dtype=I32, device=dev)
    srec = _set_rows(srec, prow, torch.stack([v0, v1, ca, cb], -1), pvalid)
    split_flag = srec[:M, 2] >= 0

    # 4. Each child's outer (slot-0) pointer: when the neighbour across
    # that face split too, the face went to the neighbour's child that
    # omits the same vertex: omitting its v0 the parent slot, its v1 cA,
    # else cB.  Faces: parent slot (v1, v2) across n0, cA (v2, v0) across
    # n1, cB (v0, v1) across n2.
    nall = torch.where(torch.cat([pvalid] * 3), torch.cat([n0, n1, n2]), -1)
    rec3 = srec[torch.where(nall >= 0, nall, 0)]
    nsplit = (nall >= 0) & (rec3[:, 2] >= 0)
    fa = torch.cat([v1, v2, v0])
    fb = torch.cat([v2, v0, v1])
    rv0, rv1 = rec3[:, 0], rec3[:, 1]
    owner = torch.where(
        (fa != rv0) & (fb != rv0),
        nall,
        torch.where((fa != rv1) & (fb != rv1), rec3[:, 2], rec3[:, 3]),
    )
    e0, e1, e2 = torch.where(nsplit, owner, nall).split(R)

    # 5. The orientations of the three children, for their cache rows and
    # the relocation record.
    p4 = pts[torch.stack([s_pid, v0, v1, v2], -1)]  # [R, 4, 2]
    s_pt, v0_pt, v1_pt, v2_pt = p4[:, 0], p4[:, 1], p4[:, 2], p4[:, 3]
    D0 = robust.orient2d_ds(s_pt, v1_pt, v2_pt)  # parent-slot child
    D1 = robust.orient2d_ds(s_pt, v2_pt, v0_pt)  # cA
    D2 = robust.orient2d_ds(s_pt, v0_pt, v1_pt)  # cB
    o = torch.where(D0 < 0, -1.0, 1.0).to(dtype)
    ct = cc.dtype
    cc_ps = torch.stack([(D0 != 0).to(ct), (s_pid + v1 + v2).to(ct)], -1)
    cc_ca = torch.stack([(D1 != 0).to(ct), (s_pid + v2 + v0).to(ct)], -1)
    cc_cb = torch.stack([(D2 != 0).to(ct), (s_pid + v0 + v1).to(ct)], -1)
    rec_f = torch.full((M + 1, 11), -1.0, dtype=dtype, device=dev)
    rec_f = _set_rows(
        rec_f,
        prow,
        torch.cat(
            [p4.reshape(R, 8), o[:, None], ca.to(dtype)[:, None],
             cb.to(dtype)[:, None]],
            -1,
        ),
        pvalid,
    )

    # 6. The rows.  Fresh child k of the block goes to slot n_tris + k.
    # (JAX writes a 2R-row block at min(n_tris, M - 2R), rolled into place
    # and masked, so that a clamped start still puts child k at
    # n_tris + k: the same rows as this scatter.)
    j2 = torch.arange(2 * R, dtype=I32, device=dev)
    blk_rows = n_tris + j2
    blk_use = j2 < 2 * n_new
    blk_v = torch.stack(
        [torch.stack([s_pid, v2, v0], -1), torch.stack([s_pid, v0, v1], -1)],
        dim=1,
    ).reshape(2 * R, 3)
    psl = torch.where(pvalid, prow, -1)
    blk_n = torch.stack(
        [torch.stack([e1, cb, psl], -1), torch.stack([e2, psl, ca], -1)],
        dim=1,
    ).reshape(2 * R, 3)
    blk_c = torch.stack([cc_ca, cc_cb], dim=1).reshape(2 * R, 2)
    tri_v = _set_rows(tri_v, blk_rows, blk_v, blk_use)
    tri_n = _set_rows(tri_n, blk_rows, blk_n, blk_use)
    cc = _set_rows(cc, blk_rows, blk_c, blk_use)
    tri_v = _set_rows(tri_v, prow, torch.stack([s_pid, v1, v2], -1), pvalid)
    tri_n = _set_rows(tri_n, prow, torch.stack([e0, ca, cb], -1), pvalid)
    cc = _set_rows(cc, prow, cc_ps, pvalid)
    n_tris = n_tris + 2 * n_new

    # 7. A non-split neighbour's pointer at a split parent goes to cA
    # (face (v2, v0)) or cB (face (v0, v1)); the n0 side keeps the parent
    # slot.  The (row, slot) targets are distinct: one flat scatter.
    nb = torch.cat([n1, n2])
    own = torch.cat([ca, cb])
    nb_ok = torch.cat([pvalid] * 2) & (nb >= 0) & ~nsplit[R:]
    nrow = tri_n[torch.where(nb_ok, nb, 0)]  # [2R, 3]
    slot = _argmax_first(nrow == torch.cat([ps] * 2)[:, None]).to(I32)
    flat = torch.where(nb_ok, nb * 3 + slot, 3 * M + 1)  # in the trash row
    tri_n = tri_n.reshape(-1).index_put((flat.long(),), own).reshape(M + 1, 3)

    # 8. Re-locate the sites of split leaves; retire the claimed ones.
    t_of = torch.where(site_tri >= 0, site_tri, 0)
    needs = (site_tri >= 0) & split_flag[t_of]
    site_tri = _relocate_sites_chunked(
        pts, site_tri, needs,
        lambda t, q: _assign_split_child_rec(rec_f, t, q), r_site,
    )
    claimed = needs & (claim[t_of] == site_ids)
    site_tri = torch.where(claimed, -1, site_tri)
    n_left = n_left - torch.sum(claimed, dtype=I32)

    # 9. The flip frontier: the parent slots and the fresh children.
    # Every new edge has a child side, from which the canonical verdict
    # and the unilateral claim of _match_and_flip execute its flip.
    dirty = _set_rows(dirty, blk_rows, torch.ones_like(blk_use), blk_use)
    dirty = _set_rows(dirty, prow, torch.ones_like(pvalid), pvalid)
    return BuildState(tri_v, tri_n, cc, n_tris, site_tri, n_left), dirty, n_new


def _sweep_round(pts, tri_v, tri_n, cc, dirty, R: int, site_tri, r_site: int,
                 rf_div: int):
    """One flip round over up to R dirty rows; returns ``(tri_v, tri_n,
    cc, dirty, site_tri, any_flip, n_exec, n_cand_edges)``."""
    M = _slots(tri_v)
    rows = _compact_rows(dirty[:M], R)
    rvalid = rows >= 0
    tv, tn, cand_ok = _edge_candidates(pts, tri_v, tri_n, cc, rows, rvalid)
    out = _match_and_flip(
        pts, tri_v, tri_n, cc, rows, rvalid, tv, tn, cand_ok,
        want_frec=site_tri is not None, rf_div=rf_div,
    )
    tri_v, tri_n, cc, _, rep, repv, any_flip, n_exec = out[:8]
    # A processed row stays dirty while it keeps a candidate edge (it lost
    # the matching or the claim); the rewritten pair rows are marked.
    # Outer neighbours stay clean: a newly violating outer edge has a
    # rewritten side, and the unilateral claim flips it from there.
    dirty = _set_rows(dirty, rows, torch.any(cand_ok, dim=-1), rvalid)
    dirty = _set_rows(dirty, rep, torch.ones_like(repv), repv)
    if site_tri is not None:
        frec = out[8]
        t_of = torch.where(site_tri >= 0, site_tri, 0)
        affected = (site_tri >= 0) & (frec[:, 5][t_of] >= 0)
        site_tri = _relocate_sites_chunked(
            pts, site_tri, affected,
            lambda t, q: _assign_flip_side_rec(frec, t, q), r_site,
        )
    n_cand = torch.sum(cand_ok, dtype=I32)
    return tri_v, tri_n, cc, dirty, site_tri, any_flip, n_exec, n_cand


def _flip_sweep_compact(
    pts, tri_v, tri_n, cc, dirty, R: int, cap: float,
    site_tri=None, r_site: int = 65536, rf_div: int = RF_DIV,
    r_tail: int | None = None,
):
    """Flip rounds over the dirty rows, up to R of them per round.

    At least one side of any possibly violating edge is dirty, and the
    dirty side alone suffices (canonical verdicts, unilateral claims), so
    rows past R simply wait.  Rounds run until no row is dirty, ``cap``
    rounds ran, or a round neither flipped nor shrank the dirty set (a
    fixpoint: the same selection would repeat it).  With ``site_tri``
    (the insert phase) the sites of flipped pairs relocate after each
    round.  With ``r_tail``, a round that starts with fewer than
    ``2 * r_tail`` dirty rows runs on an [r_tail] workspace (the final
    sweep's two rungs).  One host read per round: the flip flag and the
    counts together.

    Returns ``(tri_v, tri_n, cc, dirty, rounds, n_dirty, site_tri,
    n_flips, n_cand_edges)``, the counts as Python ints.
    """
    M = _slots(tri_v)
    n_dirty = int(torch.sum(dirty[:M]))
    rounds = n_flips = n_cands = 0
    progress = True
    while n_dirty > 0 and rounds < cap and progress:
        Rr = r_tail if r_tail is not None and n_dirty < 2 * r_tail else R
        tri_v, tri_n, cc, dirty, site_tri, any_flip, n_exec, n_cand = (
            _sweep_round(pts, tri_v, tri_n, cc, dirty, Rr, site_tri, r_site,
                         rf_div)
        )
        flipped, nd, ne, nc = torch.stack(
            [any_flip.to(I32), torch.sum(dirty[:M], dtype=I32), n_exec,
             n_cand]
        ).tolist()
        progress = bool(flipped) or nd < n_dirty
        n_dirty = nd
        n_flips += ne
        n_cands += nc
        rounds += 1
    return tri_v, tri_n, cc, dirty, rounds, n_dirty, site_tri, n_flips, n_cands


def build_2d_chunked(
    sites_std,
    cage_std,
    seed=None,
    stats: dict | None = None,
    r_compact: int = R_COMPACT,
    r_site: int = R_SITE,
    tail_floor: int | None = None,
):
    """Delaunay triangulation of cage + sites by compacted rounds.

    The algorithm of :func:`build_2d`, for large N: each insert iteration
    runs ``SPLITS_PER_ROUND`` split rounds on an ``R_s = min(R // 2,
    M // 4)``-row workspace and ``FLIPS_PER_ROUND`` flip rounds on R rows
    (R = ``r_compact``), with the sites relocated after every round.  Once
    at most ``tail_floor`` sites are left (default ``min(R_TAIL,
    r_compact // 4)``), each iteration runs one split round and one flip
    round on ``R_TAIL`` rows.  The final sweep then flips the dirty rows
    on ``r_compact`` rows, and on ``R_TAIL`` rows once fewer than twice
    that are dirty, with ``SWEEP_RF_DIV``.  If it stops at a fixpoint with
    rows still dirty, the dense :func:`_flip_rounds` finish the build.

    Args:
      sites_std: [N, 2] standardized sites, insertion-shuffled, in the
        build's dtype on its device.
      cage_std: [3, 2] standardized cage vertices.
      seed: ``(pts, BuildState, dirty)`` of :func:`_seed_state_2d`, or
        None to start from the cage triangle.
      stats: if given, receives the counts of insert iterations, split
        rounds, sweep rounds, flips and candidate edges, and the host
        seconds of the insert phase and the final sweep (each ends in a
        host read).
      r_compact, r_site, tail_floor: workspace sizes; tests shrink them to
        force overflow.

    Returns:
      (tri_v [M, 3], tri_n [M, 3], alive [M], n_tris), M = 2N + 3.
    """
    N = sites_std.shape[0]
    if seed is None:
        pts = torch.cat([cage_std.to(sites_std.dtype), sites_std])
        st = _init_state(pts, N)
        dirty = torch.zeros(2 * N + 4, dtype=torch.bool, device=pts.device)
    else:
        pts, st, dirty = seed
    M = _slots(st)
    if tail_floor is None:
        tail_floor = min(R_TAIL, r_compact // 4)
    r_site = min(r_site, R_SITE)
    counts = dict(insert_iterations=0, split_rounds=0, insert_sweep_rounds=0,
                  final_sweep_rounds=0, flips=0, candidate_edges=0,
                  cleanup_sub_rounds=0)

    t0 = time.perf_counter()
    n_new = None
    while True:
        # One host read per iteration: n_left, and the claims of the last.
        if n_new is None:
            n_left = int(st.n_left)
        else:
            n_left, claimed = torch.stack([st.n_left, n_new]).tolist()
            if n_left and not claimed:
                # JAX leaves its device loop here to grow the capacity;
                # at the full 2N + 3 slots a leaf always has room.
                raise RuntimeError(
                    f"insertion stalled with {n_left} sites left"
                )
        if n_left == 0:
            break
        tail = n_left <= tail_floor
        R = min(R_TAIL if tail else r_compact, M)
        R_s = max(min(R // 2, M // 4), 1)
        n_new = torch.zeros((), dtype=I32, device=pts.device)
        for i in range(1 if tail else SPLITS_PER_ROUND):
            if i and int(st.n_left) == 0:
                break
            st, dirty, k = _split_round_compact(pts, st, dirty, R_s, r_site)
            n_new = n_new + k
            counts["split_rounds"] += 1
        tri_v, tri_n, cc, dirty, used, _, site_tri, nf, nc = (
            _flip_sweep_compact(
                pts, st.tri_v, st.tri_n, st.cc, dirty, R,
                1 if tail else FLIPS_PER_ROUND, site_tri=st.site_tri,
                r_site=r_site,
            )
        )
        st = BuildState(tri_v, tri_n, cc, st.n_tris, site_tri, st.n_left)
        counts["insert_iterations"] += 1
        counts["insert_sweep_rounds"] += used
        counts["flips"] += nf
        counts["candidate_edges"] += nc
    t1 = time.perf_counter()

    tri_v, tri_n, cc, dirty, used, nd, _, nf, nc = _flip_sweep_compact(
        pts, st.tri_v, st.tri_n, st.cc, dirty, min(r_compact, M), math.inf,
        rf_div=SWEEP_RF_DIV, r_tail=min(R_TAIL, r_compact, M),
    )
    st = BuildState(tri_v, tri_n, cc, st.n_tris, st.site_tri, st.n_left)
    counts["final_sweep_rounds"] = used
    counts["flips"] += nf
    counts["candidate_edges"] += nc
    if nd:
        # A fixpoint with dirty rows (candidates no round can execute):
        # the dense rounds end on "nothing flipped", whatever the
        # candidates.
        log.info("build: sweep fixpoint with %d dirty rows", nd)
        st, counts["cleanup_sub_rounds"] = _flip_rounds(
            pts, st, MAX_FLIP_ROUNDS, relocate=False
        )
    if stats is not None:
        stats.update(
            counts, insert_s=t1 - t0, sweep_s=time.perf_counter() - t1
        )
    tri_v, tri_n = st.tri_v[:M], st.tri_n[:M]
    return tri_v, tri_n, tri_v[:, 0] >= 0, st.n_tris


def build_inputs(sites_raw, lo=None, hi=None, flags: int = 0, key=None,
                 dtype=torch.float64, jitter_ulps: float = 8.0):
    """What the build starts from, all on the host: ``(shift, scale,
    shuffle, cage_raw, cage_std, sites_std)``.

    ``cage_raw`` [d+1, d] is in ``dtype``'s numpy type, ``cage_std`` a
    ``dtype`` tensor, ``sites_std`` [n, d] float64 numpy: the sites
    shuffled, standardized and jittered by ``jitter_ulps`` ulps of
    ``dtype`` drawn from ``np.random.default_rng(12345)``.  The jitter is a
    deterministic symbolic perturbation for the build's predicates: exactly
    degenerate input (collinear runs, cocircular lattices) breaks the
    parallel flip schedule's tie handling.  It is kept small, since it
    displaces the triangulation from the exact points.
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
    jit_mag = jitter_ulps * machine.eps(dtype)
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
    chunk_threshold: int = CHUNK_THRESHOLD,
    seed_import: str = "auto",
    seed_min: int = SEED_MIN,
    seed_frac: int = SEED_FRAC,
):
    """End to end: standardize, cage, shuffle, build on ``device``, freeze.

    The device analog of ``simplex_tree_init`` (linear_simplex.c:134-296)
    for d = 2.  Returns a float64 DeviceTriangulation on ``device`` and the
    shuffle permutation: the response of data row i is user row
    ``shuffle[i]`` (:func:`device_tri.response_for_build`).  Flags are
    host_tree's DEFAULT / NOSTANDARDIZE / ISOSCALE.  ``dtype`` is the
    precision of the build's predicates.

    Past ``chunk_threshold`` sites the build takes the chunked route
    (:func:`build_2d_chunked`), seeded from Qhull (``seed_import`` "auto"
    or "qhull"; "self" for no seed) from ``seed_min`` sites on.  If the
    seed's walk fails, the build logs a warning and runs without a seed.
    ``stats``, if given, receives the build's counts, ``seeded`` and the
    host seconds of its phases (``setup_s``, ``seed_s``, and the chunked
    route's ``insert_s`` and ``sweep_s``).
    """
    t0 = time.perf_counter()
    sites_raw = np.asarray(sites_raw, np.float64)
    n, d = sites_raw.shape
    if d != 2:
        raise NotImplementedError(
            "the device build is 2D; use models.host_tree for general d"
        )
    if 3 * (n + 3) >= 2**24:
        # The cache's vertex-id sums must stay exact in float32.
        raise NotImplementedError(
            f"{n} sites: the vertex-id sums would be inexact in float32"
        )
    shift, scale, shuffle, cage_raw, cage_std, sites_std = build_inputs(
        sites_raw, lo, hi, flags, key, dtype
    )
    sites_dev = torch.as_tensor(sites_std, dtype=dtype, device=device)
    cage_dev = cage_std.to(device)
    stats = {} if stats is None else stats
    t1 = time.perf_counter()
    stats.update(setup_s=t1 - t0, seed_s=0.0, seeded=False)
    if n > chunk_threshold:
        seed = None
        if seed_import in ("auto", "qhull") and n >= seed_min:
            try:
                seed = _seed_state_2d(sites_std, cage_dev, seed_frac)
            except SeedLocateError as err:
                log.warning("build: %s; building without a seed", err)
            # The seed's last host read precedes its state's fills: wait
            # for them, so that ``seed_s`` ends on the seed's own work.
            profiling.synchronize(cage_dev)
            stats.update(
                seed_s=time.perf_counter() - t1, seeded=seed is not None
            )
        tri_v, tri_n, alive, _ = build_2d_chunked(
            sites_dev, cage_dev, seed=seed, stats=stats
        )
    else:
        tri_v, tri_n, alive, _ = build_2d(sites_dev, cage_dev, stats=stats)
    points_raw = np.concatenate([cage_raw, sites_raw[shuffle]])
    tri = device_tri.from_arrays(
        points_raw, shift, scale, tri_v, tri_n, alive, grid_res=grid_res,
        device=device,
    )
    return tri, shuffle
