"""Host-side incremental Delaunay engine (arbitrary dimension) — the oracle.

A from-scratch numpy implementation of the reference's simplex-tree engine
(``interpolation/linear_simplex.c``, ``edge_flip.c``): randomized
incremental Delaunay triangulation over a regular-simplex cage, with a
Guibas-Knuth history DAG for point location and circumsphere-driven
bistellar flips to restore the empty-circumsphere property.

It is a faithful copy of ``gsl_scattered_interpolation_tpu.models.host_tree``
(numpy only), so this package runs without JAX; the two must build the same
simplex sets when fed the same insertion permutation.

This engine exists for three reasons:
  1. **Oracle**: the device build is validated against it (and against
     scipy/Qhull).
  2. **Arbitrary d**: the device fast path specializes low dimensions; this
     path covers any d, like the reference.
  3. **Exact parity**: it reproduces the reference's conventions bit-for-bit
     in float64 — node/point/link layout (linear_simplex.h:31-65), negative
     seed-point ids (linear_simplex.h:82-93), tolerance constants, and the
     first-insertion topology asserted by the reference's own example
     (scattered_interp_example.c:58-77).

Differences from the reference, by design:
  * **Default insertion is Bowyer-Watson cavity insertion**, which is
    Delaunay-correct in every dimension.  The reference restores Delaunay
    only via d->d bistellar flips (edge_flip.c:211-320) and, when the flip
    would be reflex, silently leaves the violation in place
    (edge_flip.c:244-254).  In 3D that is insufficient: restoring Delaunay
    after insertion requires 3->2 flips as well (the reference's unused
    ``sub_2_type`` enum at linear_simplex.h:13 shows this was planned but
    never built), so the reference cannot maintain the empty-circumsphere
    property for d>=3.  We measured ~58% of in-sphere faces unflippable on
    uniform 3D data.  Cavity insertion has no such gap.  The reference's
    flip path is still provided (``method="flips"``) for 2D, where d->d
    flips are complete and the TPU device build parallelizes them.
  * Flip cascades use an explicit work stack, not recursion
    (edge_flip.c:305-316 recursion can be unbounded).
  * The history DAG stores children out-of-band (a ragged children table)
    instead of overloading the leaf link slots (linear_simplex.h:19),
    because cavity retirements have variable fan-out.
  * Out-of-cage queries return no-leaf (-1) / interp 0.0 instead of
    ``assert(0)`` — fixing the acknowledged TODO at linear_simplex.c:344-347.
  * No per-flip debug dump to /tmp (edge_flip.c:302-303 dev wart).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops import geometry
from ..utils import errors, machine, rng as rng_util

# Node types (linear_simplex.h:8-14, extended).
LEAF = 0
SUB_DPLUS1 = 1   # point-insertion split: d+1 children
SUB_D = 2        # bistellar flip: d children
SUB_CAVITY = 3   # Bowyer-Watson cavity retirement: variable children

# Sentinel: no neighbor / boundary. The reference uses 0 (the root cage
# simplex, never a neighbor — linear_simplex.h commentary); we keep that
# convention so topology tests can assert identical structure.
NO_NEIGHBOR = 0


@dataclasses.dataclass
class SimplexTree:
    """SoA store for the point-location DAG over simplexes in d dims.

    Pools mirror linear_simplex.h:31-59: ``tri_points[s, d+1]`` vertex ids,
    ``tri_links[s, d+1]`` child/neighbor ids, ``node_type[s]``.  Vertex ids:
    negative -(i+1) = cage seed vertex i; non-negative id maps through
    ``shuffle`` to a row of the user's data matrix.
    """

    dim: int
    capacity: int  # max number of data points

    def __post_init__(self):
        d = self.dim
        cap_s = 16 + 9 * self.capacity  # overhead factor, linear_simplex.c:63
        self.tri_points = np.zeros((cap_s, d + 1), dtype=np.int64)
        self.tri_links = np.zeros((cap_s, d + 1), dtype=np.int64)
        self.node_type = np.zeros(cap_s, dtype=np.int8)
        self.n_simplexes = 0
        self.n_points = 0
        self.seed_points = np.zeros((d + 1, d))
        self.shift = np.zeros(d)
        self.scale = np.ones(d)
        self.lo = np.zeros(d)
        self.hi = np.zeros(d)
        self.shuffle = np.arange(self.capacity, dtype=np.int64)
        self.data = None  # raw user site matrix [n, d]
        self.children = {}  # history DAG: retired node id -> list of child ids
        self.method = "cavity"  # insertion algorithm, see insert_point
        self._alloc_node()  # root cage simplex, id 0

    # -- pools ------------------------------------------------------------

    def _alloc_node(self) -> int:
        if self.n_simplexes >= self.tri_points.shape[0]:
            grow = self.tri_points.shape[0]
            self.tri_points = np.concatenate(
                [self.tri_points, np.zeros_like(self.tri_points)], axis=0
            )
            self.tri_links = np.concatenate(
                [self.tri_links, np.zeros_like(self.tri_links)], axis=0
            )
            self.node_type = np.concatenate(
                [self.node_type, np.zeros(grow, dtype=np.int8)]
            )
        idx = self.n_simplexes
        self.n_simplexes += 1
        self.node_type[idx] = LEAF
        return idx

    def is_leaf(self, node: int) -> bool:
        return self.node_type[node] == LEAF

    def n_children(self, node: int) -> int:
        t = self.node_type[node]
        if t == SUB_DPLUS1:
            return self.dim + 1
        if t == SUB_D:
            return self.dim
        return 0

    # -- coordinates ------------------------------------------------------

    def point_coords(self, pid: int) -> np.ndarray:
        """Raw coords of a point id (DATA_POINT, linear_simplex.h:82-93)."""
        if pid < 0:
            return self.seed_points[-pid - 1]
        return self.data[self.shuffle[pid]]

    def point_std(self, pid: int) -> np.ndarray:
        """Standardized coords scale*(x-shift)."""
        return self.scale * (self.point_coords(pid) - self.shift)

    def verts_std(self, node: int) -> np.ndarray:
        """(d+1, d) standardized vertex matrix of a simplex."""
        return np.stack([self.point_std(p) for p in self.tri_points[node]])

    # -- init (linear_simplex.c:134-296) ----------------------------------

    def init(
        self,
        data: np.ndarray | None = None,
        lo=None,
        hi=None,
        flags: int = 0,
        key=None,
    ) -> None:
        d = self.dim
        if data is not None:
            data = np.asarray(data, dtype=np.float64)
            if data.shape[0] > self.capacity:
                raise errors.CapacityError(
                    f"{data.shape[0]} points exceed capacity {self.capacity}"
                )
        if data is None and (lo is None or hi is None) and not (
            flags & NOSTANDARDIZE
        ):
            raise errors.InvalidArgumentError(
                "need data, or lo and hi, or NOSTANDARDIZE"
            )
        if flags & NOSTANDARDIZE:
            self.lo = np.full(d, -0.5)
            self.hi = np.full(d, +0.5)
        else:
            self.lo = (
                np.asarray(lo, dtype=np.float64)
                if lo is not None
                else data[:, :d].min(axis=0)
            )
            self.hi = (
                np.asarray(hi, dtype=np.float64)
                if hi is not None
                else data[:, :d].max(axis=0)
            )
        self.shift = (self.lo + self.hi) / 2.0
        extent = self.hi - self.lo
        self.scale = np.where(extent > 0, 1.0 / np.where(extent > 0, extent, 1), 1.0)
        if (flags & ISOSCALE) and not (flags & NOSTANDARDIZE):
            self.scale = np.full(d, self.scale.min())

        self.seed_points = geometry.cage_vertices(d, self.shift, self.scale)

        # Root cage: points -1..-(d+1), no neighbors (linear_simplex.c:262-267).
        self.tri_points[0] = -(np.arange(d + 1) + 1)
        self.tri_links[0] = NO_NEIGHBOR
        self.node_type[0] = LEAF

        if data is not None:
            self.set_data(data, key=key)
            for _ in range(data.shape[0]):
                self.insert_next()

    def set_data(self, data, key=None) -> None:
        """Attach the site matrix and insertion shuffle without inserting.

        Mirrors the reference's manual-insertion flow where the example
        drives find_leaf/insert_point itself (scattered_interp_example.c:146-153).
        """
        data = np.asarray(data, dtype=np.float64)
        if data.shape[0] > self.capacity:
            raise errors.CapacityError(
                f"{data.shape[0]} points exceed capacity {self.capacity}"
            )
        self.data = data
        self.shuffle = rng_util.insertion_shuffle(key, data.shape[0])

    def insert_next(self) -> int:
        """Locate and insert the next data point (id = n_points)."""
        pt = self.point_coords(self.n_points)
        leaf = self.find_leaf(pt)
        if leaf < 0:
            raise errors.DomainError(
                f"site {self.n_points} fell outside the cage"
            )
        self.insert_point(leaf)
        return leaf

    # -- point location (linear_simplex.c:331-402) -------------------------

    def _bary(self, node: int, q_raw: np.ndarray):
        """Bary coords of raw query in node.

        Column convention matches the reference (linear_simplex.c:614-649),
        but edge vectors are formed as ``scale*(a_raw - b_raw)`` (raw
        difference, then scale) rather than the reference's
        ``std(a) - std(b)``: subtracting first avoids catastrophic
        cancellation on the huge cage-vertex coordinates (~1e13 relative
        improvement on cage-adjacent simplexes), while agreeing with the
        reference well inside the 1e-10 parity target.
        """
        d = self.dim
        pts = self.tri_points[node]
        origin = self.point_coords(pts[d])
        M = np.stack(
            [self.scale * (self.point_coords(p) - origin) for p in pts[:d]]
        ).T
        rhs = self.scale * (q_raw - origin)
        try:
            coords = np.linalg.solve(M, rhs)
            ok = np.all(np.isfinite(coords))
        except np.linalg.LinAlgError:
            coords = np.zeros(d)
            ok = False
        return coords, ok

    @staticmethod
    def _contains(coords, ok) -> bool:
        if not ok:
            return False
        tot = coords.sum()
        return bool(
            np.all((coords >= 0) & (coords <= 1)) and 0 <= tot <= 1
        )

    @staticmethod
    def _violation(coords, ok) -> float:
        if not ok:
            return np.inf
        tot = coords.sum()
        per = max(float(np.maximum(np.maximum(-coords, coords - 1), 0).max()), 0.0)
        return max(per, max(-tot, tot - 1, 0.0))

    def find_leaf(self, q_raw: np.ndarray) -> int:
        """Descend the history DAG; -1 if outside the cage (graceful EDOM)."""
        coords, ok = self._bary(0, q_raw)
        if not self._contains(coords, ok):
            return -1
        node = 0
        while not self.is_leaf(node):
            children = self.children[node]
            best, best_v = -1, np.inf
            advanced = False
            for ch in children:
                coords, ok = self._bary(ch, q_raw)
                if self._contains(coords, ok):
                    node = ch
                    advanced = True
                    break
                v = self._violation(coords, ok)
                if v < best_v:
                    best_v, best = v, ch
            if not advanced:
                # Numerical slop: descend into the least-violating child
                # (linear_simplex.c:398-400).
                node = best
        return int(node)

    # -- circumsphere helpers ----------------------------------------------

    def _circumsphere_pts(self, pids):
        vs = np.stack([self.point_std(p) for p in pids])
        d = self.dim
        A = vs[:d] - vs[1:]
        sq = np.sum(vs * vs, axis=1)
        b = 0.5 * (sq[:d] - sq[1:])
        try:
            center = np.linalg.solve(A, b)
            if not np.all(np.isfinite(center)):
                return None, None
        except np.linalg.LinAlgError:
            return None, None
        r2 = float(np.sum((vs[0] - center) ** 2))
        return center, r2

    def in_hypersphere(self, node: int, pid: int) -> bool:
        """Strict circumsphere test with tie-break (linear_simplex.c:495-537).

        Degenerate simplexes count as containing everything (:517-521);
        radius is shrunk by 10*eps to break cospherical ties (:535-536).
        """
        center, r2 = self._circumsphere_pts(self.tri_points[node])
        if center is None:
            return True
        q = self.point_std(pid)
        dist2 = float(np.sum((q - center) ** 2))
        return dist2 < r2 * (1 - 10 * machine.DBL_EPSILON)

    # -- insertion (linear_simplex.c:404-492) -------------------------------

    def _point_in_simplex(self, node: int, pid: int) -> bool:
        return bool(np.any(self.tri_points[node] == pid))

    def insert_point(self, leaf: int) -> None:
        """Insert the next data point whose containing leaf is ``leaf``.

        ``self.method`` selects the algorithm:
          * ``"cavity"`` (default): Bowyer-Watson cavity insertion —
            Delaunay-correct in every dimension (the north-star algorithm).
          * ``"flips"``: the reference's 1->(d+1) split followed by d->d
            bistellar flip cascades (linear_simplex.c:404-492 +
            edge_flip.c) — complete in 2D only; see module docstring.
        """
        if self.method == "cavity":
            self._insert_cavity(leaf)
        else:
            self._insert_split_flips(leaf)

    def _insert_cavity(self, leaf: int) -> None:
        """Bowyer-Watson: retire every leaf whose circumsphere contains the
        new point (a connected region around ``leaf``), then star its
        boundary faces from the new point.

        Uses the same in-sphere predicate and tolerances as the flip path
        (linear_simplex.c:495-537), so the two agree in 2D up to
        cospherical ties.
        """
        assert self.is_leaf(leaf), "can only insert into a leaf"
        d = self.dim
        new_pid = self.n_points

        # Grow the cavity by BFS over neighbor links.
        cavity = {int(leaf)}
        stack = [int(leaf)]
        while stack:
            cur = stack.pop()
            for nbr in self.tri_links[cur]:
                nbr = int(nbr)
                if (
                    nbr != NO_NEIGHBOR
                    and nbr not in cavity
                    and self.in_hypersphere(nbr, new_pid)
                ):
                    cavity.add(nbr)
                    stack.append(nbr)

        # Boundary faces: faces of cavity simplexes whose neighbor is
        # outside the cavity (or the domain boundary).
        faces = []  # (face_verts, external_neighbor, owning_cavity_simplex)
        for s in sorted(cavity):
            for i in range(d + 1):
                nbr = int(self.tri_links[s, i])
                if nbr == NO_NEIGHBOR or nbr not in cavity:
                    faces.append((np.delete(self.tri_points[s], i), nbr, s))

        # Star the boundary: one new simplex per face, new point at slot 0.
        new_nodes = []
        for fv, ext, owner in faces:
            nn = self._alloc_node()
            self.tri_points[nn, 0] = new_pid
            self.tri_points[nn, 1:] = fv
            self.tri_links[nn, 0] = ext
            if ext != NO_NEIGHBOR:
                slots = np.where(self.tri_links[ext] == owner)[0]
                assert slots.size == 1, "no unique reverse link"
                self.tri_links[ext, slots[0]] = nn
            new_nodes.append(nn)

        # Internal links: slot k (k>=1) of a new simplex faces the unique
        # other new simplex sharing {new_pid} + face minus its k-th vertex.
        half_faces = {}
        for nn in new_nodes:
            for k in range(1, d + 1):
                key = tuple(sorted(np.delete(self.tri_points[nn], k).tolist()))
                half_faces.setdefault(key, []).append((nn, k))
        for key, ends in half_faces.items():
            assert len(ends) == 2, f"non-manifold cavity face {key}: {ends}"
            (a, ka), (b, kb) = ends
            self.tri_links[a, ka] = b
            self.tri_links[b, kb] = a

        # Retire the cavity into the history DAG.
        for s in cavity:
            self.node_type[s] = SUB_CAVITY
            self.children[s] = list(new_nodes)
        if len(cavity) == 1 and len(new_nodes) == d + 1:
            # Single-leaf cavity is exactly the reference's 1->(d+1) split;
            # mirror children into the link slots for structural parity with
            # linear_simplex.c:477-478.
            self.tri_links[leaf] = new_nodes
        self.n_points += 1

    def _insert_split_flips(self, leaf: int) -> None:
        """Reference algorithm: 1->(d+1) split of ``leaf``, then flips."""
        assert self.is_leaf(leaf), "can only insert into a leaf"
        d = self.dim
        new_pid = self.n_points
        self.node_type[leaf] = SUB_DPLUS1
        old_pts = self.tri_points[leaf].copy()
        old_links = self.tri_links[leaf].copy()

        children = [self._alloc_node() for _ in range(d + 1)]
        for i, ch in enumerate(children):
            # Child i omits old vertex i; new point sits at slot 0.
            rest = np.delete(old_pts, i)
            self.tri_points[ch, 0] = new_pid
            self.tri_points[ch, 1:] = rest

        # External links: child i keeps leaf's face-i neighbor at slot 0,
        # and that neighbor's reverse link is rewired to the child.
        for i, ch in enumerate(children):
            nbr = old_links[i]
            self.tri_links[ch, 0] = nbr
            if nbr != NO_NEIGHBOR:
                slots = np.where(self.tri_links[nbr] == leaf)[0]
                assert slots.size == 1, "no unique reverse link"
                self.tri_links[nbr, slots[0]] = ch

        # Internal links: the neighbor of child across the face opposite
        # vertex at slot k (k>=1) is the unique sibling not containing it.
        for i, ch in enumerate(children):
            for k in range(1, d + 1):
                v = self.tri_points[ch, k]
                sib = next(
                    s
                    for j, s in enumerate(children)
                    if j != i and not self._point_in_simplex(s, v)
                )
                self.tri_links[ch, k] = sib

        # History DAG: old leaf's links become its children.
        self.tri_links[leaf] = children
        self.children[leaf] = list(children)
        self.n_points += 1

        # Restore the Delaunay property on each new external face.
        for ch in children:
            if self.is_leaf(ch):
                self._delaunay_cascade(ch, 0)

    # -- edge flip (edge_flip.c) --------------------------------------------

    def _flippable(self, leaf: int, face: int, far_pid: int, left_out) -> bool:
        """d->d flip produces a non-reflex complex (edge_flip.c:39-95).

        For each prospective new simplex: Gram-Schmidt an orthonormal frame
        on the shared-face hyperplane (minus the left-out vertex), with the
        left-out direction last; require positive projection of (far-face)
        on that final direction.  Non-spanning vectors => default flippable.
        """
        d = self.dim
        pts = self.tri_points[leaf]
        p_face = self.point_coords(pts[face])
        p_far = self.point_coords(far_pid)
        for ismplx in range(d):
            rows = []
            for i in range(d + 1):
                if i == face:
                    continue
                idx_on_face = i if i < face else i - 1
                if idx_on_face == ismplx:
                    continue
                rows.append(self.point_coords(pts[i]) - p_face)
            rows.append(self.point_coords(pts[left_out[ismplx]]) - p_face)
            mat = np.array(rows, dtype=np.float64)
            normal = _orthonormalize_last(mat)
            if normal is None:
                return True  # vectors don't span the space
            if float(np.dot(normal, p_far - p_face)) <= 0:
                return False
        return True

    def _delaunay_cascade(self, leaf: int, face: int) -> None:
        """Iterative flip cascade (replaces recursion at edge_flip.c:305-316).

        Capped: in 3D+, in-sphere-driven d->d flips are not guaranteed to
        terminate (the reference's unbounded recursion would overflow the
        stack in the same situations).  2D cascades terminate well under
        the cap by the standard lexicographic argument.
        """
        stack = [(leaf, face)]
        budget = 1000 * (self.dim + 1)
        while stack and budget > 0:
            node, f = stack.pop()
            if not self.is_leaf(node):
                continue
            budget -= 1
            created = self._delaunay_once(node, f)
            for ch in created:
                if not self.is_leaf(ch):
                    continue
                for i in range(self.dim + 1):
                    if self.tri_links[ch, i] != NO_NEIGHBOR:
                        stack.append((ch, i))

    def _delaunay_once(self, leaf: int, face: int):
        """Check/execute one flip; returns newly created leaves."""
        d = self.dim
        neighbor = self.tri_links[leaf, face]
        if neighbor == NO_NEIGHBOR:
            return []
        assert self.is_leaf(neighbor), "neighbor of leaf is not a leaf"
        far_slots = np.where(self.tri_links[neighbor] == leaf)[0]
        assert far_slots.size >= 1, "reverse link not found"
        far = int(far_slots[0])
        far_pid = self.tri_points[neighbor, far]

        if not self.in_hypersphere(leaf, far_pid):
            return []
        # left_out[k]: which old vertex (index in leaf) new simplex k omits
        # (edge_flip.c:17-35): the k-th vertex of leaf excluding `face`.
        left_out = [k if k < face else k + 1 for k in range(d)]
        if not self._flippable(leaf, face, far_pid, left_out):
            # Collinear-point degeneracy: sphere test defaults true but flip
            # would be reflex (edge_flip.c:244-254).
            return []
        assert d > 1, "cannot flip in 1D"

        leaf_pts = self.tri_points[leaf].copy()
        nbr_pts = self.tri_points[neighbor].copy()
        # Old external neighbors, in slot order, excluding each other
        # (edge_flip.c:97-114).
        old_n1 = [
            self.tri_links[leaf, i]
            for i in range(d + 1)
            if self.tri_links[leaf, i] != neighbor
        ]
        old_n2 = [
            self.tri_links[neighbor, i]
            for i in range(d + 1)
            if self.tri_links[neighbor, i] != leaf
        ]
        assert len(old_n1) == d and len(old_n2) == d

        self.node_type[leaf] = SUB_D
        self.node_type[neighbor] = SUB_D

        news = [self._alloc_node() for _ in range(d)]
        # Points (edge_flip.c:116-146): [face vertex, far vertex, remaining
        # face vertices except the left-out one].
        for k, nn in enumerate(news):
            self.tri_points[nn, 0] = leaf_pts[face]
            self.tri_points[nn, 1] = nbr_pts[far]
            slot = 2
            for j in range(d + 1):
                if j == face:
                    continue
                idx_on_face = j if j < face else j - 1
                if idx_on_face == k:
                    continue
                self.tri_points[nn, slot] = leaf_pts[j]
                slot += 1

        # External links (edge_flip.c:148-183): slot 0 faces the neighbor's
        # old side, slot 1 the leaf's old side.
        for k, nn in enumerate(news):
            lo_pid = leaf_pts[left_out[k]]
            for slot, (olds, owner) in enumerate(
                ((old_n2, neighbor), (old_n1, leaf))
            ):
                ext = NO_NEIGHBOR
                for cand in olds:
                    if cand == NO_NEIGHBOR:
                        continue
                    if not self._point_in_simplex(cand, lo_pid):
                        ext = cand
                        break
                self.tri_links[nn, slot] = ext
                if ext != NO_NEIGHBOR:
                    rl = np.where(self.tri_links[ext] == owner)[0]
                    assert rl.size >= 1, "no reverse link found"
                    self.tri_links[ext, rl[0]] = nn

        # Internal links (edge_flip.c:185-207).
        for k, nn in enumerate(news):
            for slot in range(2, d + 1):
                v = self.tri_points[nn, slot]
                sib = next(
                    news[j]
                    for j in range(d)
                    if j != k and not self._point_in_simplex(news[j], v)
                )
                self.tri_links[nn, slot] = sib

        # History DAG links from both retired leaves (edge_flip.c:295-301).
        for k in range(d):
            self.tri_links[leaf, k] = news[k]
            self.tri_links[neighbor, k] = news[k]
        self.tri_links[leaf, d] = neighbor
        self.tri_links[neighbor, d] = leaf
        self.children[leaf] = list(news)
        self.children[neighbor] = list(news)
        return news

    # -- interpolation (linear_simplex.c:678-711) ----------------------------

    def interp(self, response: np.ndarray, q_raw: np.ndarray) -> float:
        """Barycentric interpolation at a raw query point.

        Cage (seed) vertices contribute 0, so values fade to 0 toward the
        data hull (linear_simplex.c:695-709).  Out-of-cage queries return
        0.0 (graceful handling of the reference's TODO at :344-347).
        """
        leaf = self.find_leaf(q_raw)
        if leaf < 0:
            return 0.0
        return self.interp_at(leaf, response, q_raw)

    def interp_at(self, leaf: int, response, q_raw) -> float:
        assert self.is_leaf(leaf), "interpolation must be on a leaf"
        d = self.dim
        coords, _ok = self._bary(leaf, q_raw)
        pts = self.tri_points[leaf]
        total = 0.0
        acc = 0.0
        for i in range(d):
            c = float(coords[i])
            total += c
            pid = pts[i]
            if pid >= 0:
                acc += c * float(response[self.shuffle[pid]])
        if pts[d] >= 0:
            acc += (1.0 - total) * float(response[self.shuffle[pts[d]]])
        return acc

    # -- leaf enumeration (for integrity checks / device export) -------------

    def leaves(self):
        """Ids of all current leaves, via neighbor-graph traversal from root
        descent (mirrors check_leaf_nodes, integrity_check.c:121-132)."""
        node = 0
        while not self.is_leaf(node):
            node = self.children[node][0]
        seen = {int(node)}
        stack = [int(node)]
        while stack:
            cur = stack.pop()
            for nbr in self.tri_links[cur]:
                nbr = int(nbr)
                if nbr != NO_NEIGHBOR and nbr not in seen:
                    seen.add(nbr)
                    stack.append(nbr)
        return sorted(seen)


# Init flags (linear_simplex.h:109-112).
DEFAULT = 0
NOSTANDARDIZE = 1 << 0
ISOSCALE = 1 << 1


def _orthonormalize_last(mat: np.ndarray):
    """Modified Gram-Schmidt; returns the last orthonormal row or None.

    Span test matches linear_simplex_util.h:43-70: a row whose residual
    magnitude falls below ``100*eps`` of the largest magnitude seen so far
    means the rows don't span the space.
    """
    scale = -1.0
    m = mat.astype(np.float64).copy()
    for i in range(m.shape[0]):
        mag = float(np.linalg.norm(m[i]))
        if scale < mag:
            scale = mag
        if mag < scale * 100 * machine.DBL_EPSILON:
            return None
        m[i] /= mag
        for j in range(i + 1, m.shape[0]):
            m[j] -= np.dot(m[i], m[j]) * m[i]
    return m[-1]


def build(
    data,
    lo=None,
    hi=None,
    flags: int = DEFAULT,
    key=None,
    capacity: int | None = None,
    method: str = "cavity",
) -> SimplexTree:
    """Convenience: allocate + init a SimplexTree from a site matrix."""
    data = np.asarray(data, dtype=np.float64)
    n, d = data.shape
    tree = SimplexTree(dim=d, capacity=capacity or n)
    tree.method = method
    tree.init(data, lo=lo, hi=hi, flags=flags, key=key)
    return tree
