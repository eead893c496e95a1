"""Port's dense 2D locate (the Hopper kernel's plain version) vs the JAX
package's Pallas kernel (interpret mode) and its XLA dense locate."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.models import device_tri as jdt
from gsl_scattered_interpolation_tpu.models import host_tree as jht
from gsl_scattered_interpolation_tpu.ops import pallas_locate as jpl
from gsl_scattered_interpolation_tpu.utils import datasets

from gsl_scattered_interpolation_torch.models import convert
from gsl_scattered_interpolation_torch.ops import locate
from gsl_scattered_interpolation_torch.utils import errors


def _fields(jtri):
    return {k: np.asarray(v) for k, v in jtri._asdict().items()}


@pytest.fixture(scope="module")
def weather32():
    """JAX weather triangulation in float32 and the port's copy of it."""
    sites, _ = datasets.weather()
    jtri = jdt.freeze(jht.build(sites, key=0)).cast(jnp.float32)
    tri, _ = convert.from_jax_arrays(_fields(jtri), device="cpu")
    rng = np.random.default_rng(5)
    Q = rng.uniform([-89.5, 41.0], [-86.5, 43.1], size=(1500, 2)).astype(
        np.float32
    )
    return jtri, tri, Q


def test_plain_matches_pallas_interpret_and_dense(weather32):
    jtri, tri, Q = weather32
    jq = jnp.asarray(Q)
    pallas = np.asarray(jpl.locate_dense_pallas(jtri, jq, interpret=True))
    dense = np.asarray(jdt.locate_dense(jtri, jq)[0])
    ours = locate.locate_dense_ref(tri, torch.as_tensor(Q)).numpy()
    np.testing.assert_array_equal(ours, pallas)
    np.testing.assert_array_equal(ours, dense)
    assert ours.dtype == np.int32


def test_wrapper_on_cpu_is_the_plain_version(weather32):
    _, tri, Q = weather32
    q = torch.as_tensor(Q)
    before = locate.locate2d_cuda.launches
    got = locate.locate_dense_kernel(tri, q)
    np.testing.assert_array_equal(got.numpy(), locate.locate_dense_ref(tri, q))
    assert locate.locate2d_cuda.launches == before  # nothing was launched


def test_tables_match_pallas_packing(weather32):
    # pallas_locate.py:104-123, in float32 and centred at tri.shift.
    jtri, tri, _ = weather32
    T = jtri.n_tris
    A = np.asarray(jtri.affine[:, :4], np.float32).reshape(T, 2, 2)
    anchor = np.asarray(jtri.affine[:, 4:6], np.float32)
    w0 = np.asarray(jtri.affine[:, 6:], np.float32)
    c0 = np.asarray(jtri.shift, np.float32)
    bias = w0 + np.sum(A * (c0 - anchor)[:, None, :], axis=-1)
    centre, g_pack, b_pack = locate.pack_tables(tri)
    np.testing.assert_array_equal(centre.numpy(), c0)
    np.testing.assert_array_equal(
        g_pack.numpy(), np.concatenate([A[:, 0, :].T, A[:, 1, :].T])
    )
    np.testing.assert_array_equal(b_pack.numpy(), bias.T)


def test_tables_are_packed_once_per_triangulation(weather32):
    _, tri, _ = weather32
    first = tri.locate_tables
    assert tri.locate_tables is first
    for got, want in zip(first, locate.pack_tables(tri)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    # cast and to build a new triangulation, which packs its own tables.
    assert tri.cast(torch.float64).locate_tables is not first


@pytest.mark.parametrize("block", [7, 512, 4096])
def test_blocking_does_not_change_leaves(weather32, block):
    _, tri, Q = weather32
    centre, g_pack, b_pack = locate.pack_tables(tri)
    qc = (torch.as_tensor(Q) - centre).contiguous()
    np.testing.assert_array_equal(
        locate.locate2d_ref(qc, g_pack, b_pack, block=block),
        locate.locate2d_ref(qc, g_pack, b_pack),
    )


def test_tie_goes_to_lowest_index_and_degenerate_never_wins():
    # Columns 1 and 3 score the same for every query; column 0 is a
    # degenerate triangle (bias -1e30), column 2 is worse everywhere.
    g = torch.tensor(
        [[0.0, 1.0, 0.0, 1.0], [0.0, 0.0, 0.0, 0.0],
         [0.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 1.0]]
    )
    b = torch.tensor([[-1e30, 0.2, -5.0, 0.2], [-1e30, 0.2, -5.0, 0.2]])
    q = torch.tensor([[0.1, 0.1], [-0.05, 0.02], [3.0, -2.0]])
    np.testing.assert_array_equal(locate.locate2d_ref(q, g, b), [1, 1, 1])


def test_kernel_wrapper_refuses_cpu_tensors(weather32):
    _, tri, Q = weather32
    centre, g_pack, b_pack = locate.pack_tables(tri)
    with pytest.raises(errors.InvalidArgumentError):
        locate.locate2d_cuda(torch.as_tensor(Q), g_pack, b_pack, centre)


def test_only_2d():
    from gsl_scattered_interpolation_torch.models import device_tri, host_tree

    sites = np.random.default_rng(3).uniform(-0.5, 0.5, size=(10, 3))
    tri = device_tri.freeze(host_tree.build(sites), device="cpu")
    with pytest.raises(errors.InvalidArgumentError):
        locate.pack_tables(tri)


def test_weights_wrapper_on_cpu_is_the_plain_version(weather32):
    # Leaves as JAX's Pallas kernel (interpret mode) gives them, weights as
    # device_tri._weights of the plain version's leaves, nothing launched.
    from gsl_scattered_interpolation_torch.models import device_tri

    jtri, tri, Q = weather32
    q = torch.as_tensor(Q)
    before = (locate.locate2d_cuda.launches, locate.locate2d_cuda.kernel_launches)
    leaf, w = locate.locate_weights_kernel(tri, q)
    assert (locate.locate2d_cuda.launches, locate.locate2d_cuda.kernel_launches) == before
    pallas = np.asarray(jpl.locate_dense_pallas(jtri, jnp.asarray(Q), interpret=True))
    np.testing.assert_array_equal(leaf.numpy(), pallas)
    ref = locate.locate_dense_ref(tri, q)
    np.testing.assert_array_equal(leaf.numpy(), ref.numpy())
    assert leaf.dtype == torch.int32 and w.dtype == torch.float32 and w.shape == (1500, 3)
    torch.testing.assert_close(w, device_tri._weights(tri, ref, q), rtol=0, atol=0)


def test_weights_wrapper_keeps_float64_weights(weather32):
    from gsl_scattered_interpolation_torch.models import device_tri

    _, tri, Q = weather32
    tri64 = tri.cast(torch.float64)
    q = torch.as_tensor(Q, dtype=torch.float64)
    leaf, w = locate.locate_weights_kernel(tri64, q)
    assert w.dtype == torch.float64
    np.testing.assert_array_equal(leaf.numpy(), locate.locate_dense_ref(tri64, q).numpy())
    torch.testing.assert_close(w, device_tri._weights(tri64, leaf, q), rtol=0, atol=0)


def test_pallas_route_takes_leaves_and_weights_from_one_call(weather32, monkeypatch):
    from gsl_scattered_interpolation_torch.models import device_tri

    _, tri, Q = weather32
    q = torch.as_tensor(Q)
    resp = torch.linspace(-1.0, 2.0, tri.points_raw.shape[0])
    calls = []
    orig = locate.locate_weights_kernel

    def counted(*args):
        calls.append(1)
        return orig(*args)

    monkeypatch.setattr(locate, "locate_weights_kernel", counted)
    got = device_tri.interp(tri, resp, q, method="pallas")
    assert len(calls) == 1
    leaf = locate.locate_dense_ref(tri, q)
    w = device_tri._weights(tri, leaf, q)
    want = torch.sum(w * resp[tri.tri_verts[leaf]], dim=-1)
    want = torch.where(device_tri._in_domain(w), want, 0.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _split_argmax(score, bounds):
    """The kernel's merge, plain: each slice's first maximum as a key, the
    largest key over the slices from the key of (-inf, 0)."""
    keys = [locate.merge_key_ref(torch.full((score.shape[0],), float("-inf")),
                                 torch.zeros(score.shape[0], dtype=torch.int32))]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        part = score[:, lo:hi]
        best, arg = part.max(dim=1)
        # A slice with nothing above -inf publishes no key.
        key = locate.merge_key_ref(best, arg + lo)
        keys.append(torch.where(best > float("-inf"), key, keys[0]))
    return locate.merge_key_index(torch.stack(keys).amax(dim=0))


def _adversarial_scores():
    ninf = float("-inf")
    return {
        # the same maximum in every slice: the first slice's index wins
        "dup_max": [[0.5, 0.1, 0.5, 0.2, 0.5, 0.5]],
        # -0 before +0 and +0 before -0, all else negative
        "signed_zero": [[-1.0, -0.0, -3.0, 0.0, -2.0, -0.0],
                        [-1.0, 0.0, -3.0, -0.0, -2.0, 0.0]],
        # degenerate triangles' -1e30 scores, and one only reachable row
        "degenerate": [[-1e30, -1e30, -1e30, -5.0, -1e30, -1e30],
                       [-1e30, -1e30, -1e30, -1e30, -1e30, -1e30]],
        # nothing above -inf: leaf 0
        "all_ninf": [[ninf] * 6],
        "late_max": [[ninf, -1e30, -7.0, ninf, -3.0, -2.0]],
    }


@pytest.mark.parametrize("case", sorted(_adversarial_scores()))
@pytest.mark.parametrize("bounds", [(0, 6), (0, 2, 4, 6), (0, 1, 3, 6), (0, 1, 2, 3, 4, 5, 6)])
def test_merge_key_gives_first_maximum(case, bounds):
    score = torch.tensor(_adversarial_scores()[case], dtype=torch.float32)
    want = torch.argmax(score, dim=1).to(torch.int32)
    torch.testing.assert_close(_split_argmax(score, bounds), want, rtol=0, atol=0)


def test_merge_key_orders_like_the_scores():
    rng = np.random.default_rng(11)
    s = np.concatenate([rng.normal(size=200) * 10.0 ** rng.integers(-30, 30, 200),
                        [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45]]).astype(np.float32)
    order = np.argsort(s, kind="stable")
    keys = locate.merge_key_ref(torch.as_tensor(s), torch.zeros(s.size, dtype=torch.int32))
    assert np.all(np.diff(keys.numpy()[order]) >= 0)
    # Equal scores: the lower index has the larger key; -0 equals +0.
    z = locate.merge_key_ref(torch.tensor([0.0, -0.0, 0.0]), torch.tensor([5, 3, 9]))
    assert z[1] > z[0] > z[2]
    idx = torch.tensor([0, 7, 2**31 - 1])
    np.testing.assert_array_equal(
        locate.merge_key_index(locate.merge_key_ref(torch.ones(3), idx)), idx)
    assert locate.INITIAL_KEY == int(
        locate.merge_key_ref(torch.tensor([float("-inf")]), torch.tensor([0]))[0])


@pytest.mark.parametrize("n_q,n_t", [(1, 1), (1, 3), (257, 1021), (70_001, 3_001),
                                     (50_000, 100_971), (1_000_000, 4_001),
                                     (1_000_000, 16_001), (100_000, 400_001)])
def test_plan_covers_every_triangle_once(n_q, n_t):
    slices, length = locate.plan(n_q, n_t, 132)
    assert length % locate.GROUP == 0 and 1 <= slices <= locate.MAX_SLICES
    assert (slices - 1) * length < n_t <= slices * length
    assert locate.kernels_per_call(slices) == (1 if slices == 1 else 2)


def test_plan_fills_the_card():
    # bench.py's boundary check (T = 100,971, 50,000 queries): one slice
    # would leave each SM under one block; the split gives every SM at
    # least MIN_BLOCKS_PER_SM and evens them out.
    tiles = -(-50_000 // (locate.ROWS * locate.THREADS))
    slices, length = locate.plan(50_000, 100_971, 132)
    assert slices > 1 and tiles * slices >= 132 * locate.MIN_BLOCKS_PER_SM
    assert 100_971 * tiles / 132 / (-(-tiles * slices // 132) * length) > 0.9
    # The headline (10^6 queries, T = 4,001): 977 tiles take two slices.
    assert locate.plan(1_000_000, 4_001, 132) == (2, 2016)


def test_launch_geometry_is_the_sources():
    # plan() models the grid the source launches: one definition of each
    # constant, read from the .cu file.
    from gsl_scattered_interpolation_torch.kernels import build

    src = (build.CSRC / "locate2d.cu").read_text()
    for name, value in (("kThreads", locate.THREADS), ("kGroup", locate.GROUP),
                        ("kRows", locate.ROWS)):
        assert f"constexpr int {name} = {value};" in src
    assert (locate.THREADS, locate.GROUP, locate.ROWS) == (128, 32, 8)


def test_kernel_wrapper_refuses_cpu_weights(weather32):
    _, tri, Q = weather32
    centre, g_pack, b_pack = tri.locate_tables
    with pytest.raises(errors.InvalidArgumentError):
        locate.locate2d_cuda(torch.as_tensor(Q), g_pack, b_pack, centre=centre,
                             affine=tri.affine)
