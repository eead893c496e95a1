"""The port's flip-candidate verdict (ops/candmath.py) against the JAX
package's XLA math and its Pallas kernel in interpret mode, on a real
mid-build state (the fixture of tests/test_pallas_candmath.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import device_delaunay as jdd
from gsl_scattered_interpolation_tpu.ops import geometry as jgeometry
from gsl_scattered_interpolation_tpu.ops import pallas_candmath as pcm

from gsl_scattered_interpolation_torch.models import convert
from gsl_scattered_interpolation_torch.models import device_delaunay as dd
from gsl_scattered_interpolation_torch.ops import candmath, robust
from gsl_scattered_interpolation_torch.utils import errors

DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]


def _mid_build_state(n=400, dtype=jnp.float32, seed=3):
    """A few JAX build rounds: (pts, partially built state).  Jitted for
    speed; both packages then start from this same state."""
    rng = np.random.default_rng(seed)
    sites = rng.uniform(-0.5, 0.5, size=(n, 2)).astype(np.float64)
    cage = jgeometry.cage_vertices(2, np.zeros(2), np.ones(2), np.float64)
    pts = jnp.asarray(np.concatenate([cage, sites]), dtype)
    st = jdd._init_state(pts, n, jnp.int32(n), cap=2 * n + 3)
    split = jax.jit(jdd._split_round)
    flips = jax.jit(jdd._flip_rounds, static_argnums=2)
    for _ in range(4):
        st = split(pts, st)
        st, _ = flips(pts, st, 2)
    return pts, st


def _jax_math_inputs(pts, st):
    """The arguments _edge_candidates feeds _edge_candidates_math, as in
    tests/test_pallas_candmath.py."""
    M = st.tri_v.shape[0]
    rows = jnp.arange(M, dtype=jnp.int32)
    tv = st.tri_v[rows]
    tn = st.tri_n[rows]
    alive = tv[:, 0] >= 0
    cok = st.cc[:, 0] > 0.5
    valid3 = alive[:, None] & (tn >= 0)
    uu3 = jnp.where(valid3, tn, 0)
    ccu = jgeometry.take_rows(st.cc, uu3)
    degen_u = ~(ccu[..., 0] > 0.5)
    p1_id = jnp.roll(tv, -1, axis=1)
    p2_id = jnp.roll(tv, -2, axis=1)
    far3 = jnp.clip(ccu[..., 1].astype(jnp.int32) - p1_id - p2_id, 0, pts.shape[0] - 1)
    p6 = jgeometry.take_rows(pts, jnp.concatenate([tv, far3], axis=1))
    return (p6[:, :3], p6[:, 3:], tv, p1_id, far3, p2_id, valid3, cok, degen_u)


@pytest.fixture(scope="module", params=DTYPES, ids=["f32", "f64"])
def state(request):
    jdtype, dtype = request.param
    pts, st = _mid_build_state(dtype=jdtype)
    args = _jax_math_inputs(pts, st)
    return pts, st, args, dtype


def test_plain_version_equals_xla_math_and_pallas(state):
    pts, st, args, dtype = state
    ref = np.asarray(jdd._edge_candidates_math(*args))
    pallas = np.asarray(pcm.candidates_math_pallas(*args, interpret=True))
    ours = candmath.edge_candidates_math_ref(*(torch.tensor(np.asarray(a)) for a in args))
    assert ours.dtype == torch.bool and ours.shape == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(ours.numpy(), pallas)
    assert ref.sum() > 0  # a non-trivial state


def test_port_gathers_equal_jax_gathers(state):
    pts, st, args, dtype = state
    ours = convert.from_jax_build_state(
        {k: np.asarray(v) for k, v in st._asdict().items()}, device="cpu"
    )
    tpts = torch.tensor(np.asarray(pts))
    M = st.tri_v.shape[0]
    rows = torch.arange(M, dtype=torch.int32)
    _, _, targs = dd._edge_candidate_inputs(
        tpts, ours.tri_v, ours.tri_n, ours.cc, rows, torch.ones(M, dtype=torch.bool)
    )
    for got, want in zip(targs, args):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    before = candmath.edge_candidates_math_cuda.launches
    tv, tn, cand = dd._edge_candidates(
        tpts, ours.tri_v, ours.tri_n, ours.cc, rows, torch.ones(M, dtype=torch.bool)
    )
    assert candmath.edge_candidates_math_cuda.launches == before  # CPU: plain
    jtv, jtn, jcand = jdd._edge_candidates(
        pts, st.tri_v, st.tri_n, st.cc, jnp.arange(M, dtype=jnp.int32), jnp.ones(M, bool)
    )
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jtn))


def test_dispatch_and_wrapper_checks():
    R = 5
    args = (
        torch.zeros(R, 3, 2), torch.zeros(R, 3, 2),
        torch.zeros(R, 3, dtype=torch.int32), torch.zeros(R, 3, dtype=torch.int32),
        torch.zeros(R, 3, dtype=torch.int32), torch.zeros(R, 3, dtype=torch.int32),
        torch.ones(R, 3, dtype=torch.bool), torch.ones(R, dtype=torch.bool),
        torch.zeros(R, 3, dtype=torch.bool),
    )
    out = candmath.edge_candidates_math(*args)
    assert out.shape == (R, 3) and not out.any()  # all-zero quads: no flip
    a = args
    with pytest.raises(errors.InvalidArgumentError):  # CPU tensors
        candmath.edge_candidates_math_cuda(a[0], a[1], a[2], a[4], a[6], a[7], a[8])
    with pytest.raises(errors.InvalidArgumentError):
        candmath.edge_candidates_math(*(x.to("meta") for x in args))


class _Trace:
    """Records the distinct adds and multiplies that a predicate's result
    needs.

    A value is a node of a shared graph; negation is free (an operand
    modifier on the card), add and multiply commute, and an expression
    that repeats one already built is the same node, as the compiler folds
    it in the kernel's inlined helpers.  Only the nodes that the result
    depends on count: the compiler drops the rest (the error term of the
    last two-sum)."""

    def __init__(self):
        self.nodes = {}

    def node(self, key):
        return self.nodes.setdefault(key, len(self.nodes))

    def ops(self, result):
        keys = {ref: key for key, ref in self.nodes.items()}
        live, todo = set(), [result.ref]
        while todo:
            ref = todo.pop()
            if ref not in live:
                live.add(ref)
                key = keys[ref]
                if key[0] == "add":
                    todo += [key[1][0], key[2][0]]
                elif key[0] == "mul":
                    todo += [key[1], key[2]]
        return sum(keys[ref][0] in ("add", "mul") for ref in live)


class _Val:
    dtype = torch.float32

    def __init__(self, trace, ref, neg=False):
        self.trace, self.ref, self.neg = trace, ref, neg

    def _lift(self, o):
        if isinstance(o, _Val):
            return o
        return _Val(self.trace, self.trace.node(("const", o)))

    def __neg__(self):
        return _Val(self.trace, self.ref, not self.neg)

    def __add__(self, o):
        o = self._lift(o)
        a, b = sorted([(self.ref, self.neg), (o.ref, o.neg)])
        return _Val(self.trace, self.trace.node(("add", a, b)))

    def __sub__(self, o):
        return self + (-self._lift(o))

    def __mul__(self, o):
        o = self._lift(o)
        a, b = sorted([self.ref, o.ref])
        return _Val(self.trace, self.trace.node(("mul", a, b)), self.neg != o.neg)

    __radd__ = __add__
    __rmul__ = __mul__


class _Point:
    dtype = torch.float32

    def __init__(self, trace, name):
        self.xy = [_Val(trace, trace.node(("in", name, k))) for k in range(2)]

    def __getitem__(self, index):
        return self.xy[index[-1]]


@pytest.mark.parametrize(
    "fn,n_points,counted",
    [(robust.orient2d_ds, 3, candmath.ORIENT2D_OPS),
     (robust.incircle_ds, 4, candmath.INCIRCLE_OPS)],
    ids=["orient2d", "incircle"],
)
def test_bound_counts_each_distinct_operation_once(fn, n_points, counted):
    trace = _Trace()
    result = fn(*(_Point(trace, k) for k in range(n_points)))
    assert trace.ops(result) == counted
