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
    qc = (torch.as_tensor(Q) - centre).contiguous()
    with pytest.raises(errors.InvalidArgumentError):
        locate.locate2d_cuda(qc, g_pack, b_pack)


def test_only_2d():
    from gsl_scattered_interpolation_torch.models import device_tri, host_tree

    sites = np.random.default_rng(3).uniform(-0.5, 0.5, size=(10, 3))
    tri = device_tri.freeze(host_tree.build(sites), device="cpu")
    with pytest.raises(errors.InvalidArgumentError):
        locate.pack_tables(tri)
