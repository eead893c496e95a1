"""Tridiagonal solvers of the cubic splines: the Hopper kernel and its plain
version.

The counterpart of ``gsl_scattered_interpolation_tpu/ops/tridiag.py``,
which replaces the two GSL solvers the spline kernels use,
``gsl_linalg_solve_symm_tridiag`` (cspline.c:137) and
``gsl_linalg_solve_symm_cyc_tridiag`` (cspline.c:212), by ``lax.scan``
Thomas sweeps.  Here the sweeps are ``kernels/csrc/tridiag.cu``: one thread
per right-hand side, m right-hand sides sharing the matrix in an [n, m]
layout (``interp2d`` solves every row or column of a grid in one launch).

On a CUDA tensor :func:`thomas` launches the kernel and raises if it
cannot; on a CPU tensor it runs :func:`thomas_ref`, the recurrence as a
Python loop over tensors, which the kernel (built with ``-fmad=false``)
equals bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build
from ..utils import errors

KERNEL = "tridiag"
# Per row and right-hand side: the forward sweep's 2 multiplies, 2
# subtracts and 2 divisions, the back substitution's multiply and
# subtract (a division counted as one operation).
OPS_PER_ROW = 8


def thomas_ref(diag, offdiag, rhs):
    """Plain version: x [n, m] with ``A x = rhs`` for the symmetric
    tridiagonal A of ``diag`` [n] and ``offdiag`` [n-1], rhs [n, m].

    JAX's scans (``ops/tridiag.py:27-48``) as a loop over rows: c' is one
    value per row, d' and x one row of m values.
    """
    n = diag.shape[0]
    zero = torch.zeros((), dtype=diag.dtype, device=diag.device)
    ds = diag.unbind(0)
    es = list(offdiag.unbind(0)) + [zero]
    bs = rhs.unbind(0)
    c_prev, d_prev, e_prev = zero, torch.zeros_like(bs[0]), zero
    cps, dps = [], []
    for i in range(n):
        denom = ds[i] - e_prev * c_prev
        c_prev = es[i] / denom
        d_prev = (bs[i] - e_prev * d_prev) / denom
        cps.append(c_prev)
        dps.append(d_prev)
        e_prev = es[i]
    xs = [None] * n
    x_next = torch.zeros_like(bs[0])
    for i in range(n - 1, -1, -1):
        x_next = dps[i] - cps[i] * x_next
        xs[i] = x_next
    return torch.stack(xs)


def thomas_cuda(diag, offdiag, rhs):
    """Launch the kernel: x [n, m] on the card for contiguous float32 or
    float64 ``diag`` [n], ``offdiag`` [n-1] and ``rhs`` [n, m].

    Adds one to ``thomas_cuda.launches`` for each launch.
    """
    dev = rhs.device
    if dev.type != "cuda":
        raise errors.InvalidArgumentError("thomas_cuda needs CUDA tensors")
    dtype = rhs.dtype
    if dtype not in (torch.float32, torch.float64):
        raise errors.InvalidArgumentError(f"unsupported dtype {dtype}")
    if rhs.dim() != 2:
        raise errors.InvalidArgumentError("rhs must be [n, m]")
    n, m = rhs.shape
    build.check_arg("diag", diag, (n,), dtype, dev)
    build.check_arg("offdiag", offdiag, (max(n - 1, 0),), dtype, dev)
    build.check_arg("rhs", rhs, (n, m), dtype, dev)
    if n >= 2**31 or m >= 2**31:  # int row and column counts in the kernel
        raise errors.InvalidArgumentError(f"unsupported size n={n}, m={m}")
    x = torch.empty_like(rhs)
    if n == 0 or m == 0:
        return x
    cp = torch.empty_like(rhs)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(diag.data_ptr(), offdiag.data_ptr(), rhs.data_ptr(),
                 cp.data_ptr(), x.data_ptr(), n, m,
                 int(dtype == torch.float64), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    thomas_cuda.launches += 1
    return x


thomas_cuda.launches = 0


def _launcher():
    fn = build.load(KERNEL).tridiag_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return fn


def thomas(diag, offdiag, rhs):
    """x [n, m]: the Hopper kernel for CUDA tensors, the plain version for
    CPU tensors (arguments as :func:`thomas_ref`)."""
    dev = rhs.device.type
    if dev == "cuda":
        return thomas_cuda(
            diag.contiguous(), offdiag.contiguous(), rhs.contiguous()
        )
    if dev == "cpu":
        return thomas_ref(diag, offdiag, rhs)
    raise errors.InvalidArgumentError(f"no tridiag kernel for {rhs.device}")


def solve_symm_tridiag(diag, offdiag, rhs):
    """Solve the symmetric tridiagonal ``A x = rhs``.

    diag [n], offdiag [n-1] (sub == super), rhs [n] or [n, m] (m systems
    that share A); x has rhs's shape.
    """
    n = diag.shape[0]
    if n == 1:
        return rhs / (diag if rhs.dim() == 1 else diag[:, None])
    x = thomas(diag, offdiag, rhs if rhs.dim() == 2 else rhs[:, None])
    return x if rhs.dim() == 2 else x[:, 0]


def solve_symm_cyc_tridiag(diag, offdiag, rhs):
    """Solve the symmetric cyclic tridiagonal ``A x = rhs`` by
    Sherman-Morrison, as JAX does (``ops/tridiag.py:53-77``).

    diag [n], offdiag [n] (offdiag[n-1] couples row n-1 with row 0),
    rhs [n].  The two solves with the modified diagonal, y and z, are one
    launch with m = 2.
    """
    n = diag.shape[0]
    if n == 1:
        return rhs / (diag + 2 * offdiag)
    if n == 2:
        # Dense 2x2: corner and offdiag coincide.
        a, d = diag[0], diag[1]
        b = offdiag[0] + offdiag[1]
        det = a * d - b * b
        x0 = (d * rhs[0] - b * rhs[1]) / det
        x1 = (a * rhs[1] - b * rhs[0]) / det
        return torch.stack([x0, x1])
    alpha = offdiag[-1]  # the cyclic corner
    gamma = -diag[0]
    dmod = diag.clone()
    dmod[0] = diag[0] - gamma
    dmod[-1] = diag[-1] - alpha * alpha / gamma
    u = torch.zeros_like(rhs)
    u[0] = gamma
    u[-1] = alpha
    v = torch.zeros_like(rhs)
    v[0] = 1.0
    v[-1] = alpha / gamma
    yz = thomas(dmod, offdiag[:-1], torch.stack([rhs, u], dim=-1))
    y, z = yz[:, 0], yz[:, 1]
    factor = (v @ y) / (1.0 + v @ z)
    return y - factor * z
