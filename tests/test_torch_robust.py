"""The port's compensated predicates (ops/robust.py) against the JAX
package's, bit for bit.

The JAX functions are called without jit, so each operation rounds on its
own, as eager PyTorch and the CUDA kernels built with -fmad=false do.  (A
jitted f32 chain may round differently; the build itself calls the
predicates op by op in both packages' parity runs.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsl_scattered_interpolation_tpu.ops import robust as jrobust

from gsl_scattered_interpolation_torch.ops import robust

DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


def _points(rng, n, d, k, np_dtype):
    """[n, k, d] points: data scale, cage scale, and near-degenerate sets
    (the last point of a row close to the line or circle of the others)."""
    data = rng.uniform(-0.5, 0.5, size=(n, k, d))
    cage = rng.uniform(-60.0, 60.0, size=(n, k, d))
    mixed = data.copy()
    mixed[:, 0] = cage[:, 0]  # one cage vertex among data points
    near = data.copy()
    t = rng.uniform(-1, 1, size=(n, 1))
    near[:, -1] = near[:, 0] + t * (near[:, 1] - near[:, 0])
    near[:, -1] += rng.uniform(-1, 1, size=(n, d)) * 1e-7
    return np.concatenate([data, cage, mixed, near]).astype(np_dtype)


def _same_bits(ours, ref):
    a = ours.numpy()
    b = np.asarray(ref)
    assert a.dtype == b.dtype and a.shape == b.shape
    view = np.int32 if a.dtype == np.float32 else np.int64
    np.testing.assert_array_equal(a.view(view), b.view(view))


@pytest.mark.parametrize("np_dtype,dtype", DTYPES)
def test_orient2d_and_incircle_bit_equal(np_dtype, dtype):
    P = _points(np.random.default_rng(0), 5000, 2, 4, np_dtype)
    t = [torch.from_numpy(P[:, i].copy()) for i in range(4)]
    j = [jnp.asarray(P[:, i]) for i in range(4)]
    _same_bits(robust.orient2d_ds(*t[:3]), jrobust.orient2d_ds(*j[:3]))
    _same_bits(robust.incircle_ds(*t), jrobust.incircle_ds(*j))
    # The sign of the near-degenerate quads is what the build decides on.
    assert (robust.incircle_ds(*t) != 0).float().mean() > 0.99


def test_signs_agree_with_exact_float64():
    # float32 inputs, exactly representable in float64: the compensated
    # float32 sign equals the float64 sign away from astronomically thin
    # ties.
    P = _points(np.random.default_rng(5), 3000, 2, 4, np.float32)
    t32 = [torch.from_numpy(P[:, i].copy()) for i in range(4)]
    t64 = [x.double() for x in t32]
    s32 = torch.sign(robust.incircle_ds(*t32))
    s64 = torch.sign(robust.incircle_ds(*t64))
    assert (s32 == s64).float().mean() > 0.999
    torch.testing.assert_close(
        torch.sign(robust.orient2d_ds(*t32[:3])).double(),
        torch.sign(robust.orient2d_ds(*t64[:3])),
    )


@pytest.mark.parametrize("np_dtype,dtype", DTYPES)
def test_orient3d_and_insphere_bit_equal(np_dtype, dtype):
    P = _points(np.random.default_rng(1), 3000, 3, 5, np_dtype)
    t = [torch.from_numpy(P[:, i].copy()) for i in range(5)]
    j = [jnp.asarray(P[:, i]) for i in range(5)]
    _same_bits(robust.orient3d_ds(*t[:4]), jrobust.orient3d_ds(*j[:4]))
    _same_bits(robust.insphere_ds(*t), jrobust.insphere_ds(*j))
    assert (robust.insphere_ds(*t) != 0).float().mean() > 0.99


@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("np_dtype,dtype", DTYPES)
def test_nd_predicates_bit_equal(d, np_dtype, dtype):
    P = _points(np.random.default_rng(d), 1000, d, d + 2, np_dtype)
    verts, q = torch.from_numpy(P[:, : d + 1].copy()), torch.from_numpy(P[:, d + 1].copy())
    _same_bits(robust.orientnd_ds(verts), jrobust.orientnd_ds(jnp.asarray(P[:, : d + 1])))
    _same_bits(
        robust.inspherend_ds(verts, q),
        jrobust.inspherend_ds(jnp.asarray(P[:, : d + 1]), jnp.asarray(P[:, d + 1])),
    )


def test_3d_signs_agree_with_exact_float64():
    # float32 inputs, exact in float64: the compensated float32 signs of
    # orient3d and insphere equal the float64 ones away from thin ties.
    P = _points(np.random.default_rng(6), 3000, 3, 5, np.float32)
    t32 = [torch.from_numpy(P[:, i].copy()) for i in range(5)]
    t64 = [x.double() for x in t32]
    s32 = torch.sign(robust.insphere_ds(*t32))
    s64 = torch.sign(robust.insphere_ds(*t64))
    assert (s32 == s64).float().mean() > 0.999
    o32 = torch.sign(robust.orient3d_ds(*t32[:4])).double()
    assert (o32 == torch.sign(robust.orient3d_ds(*t64[:4]))).float().mean() > 0.999
