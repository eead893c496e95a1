"""Tridiagonal solvers of the cubic splines: the Hopper kernel and its plain
version.

The counterpart of ``gsl_scattered_interpolation_tpu/ops/tridiag.py``,
which replaces the two GSL solvers the spline kernels use,
``gsl_linalg_solve_symm_tridiag`` (cspline.c:137) and
``gsl_linalg_solve_symm_cyc_tridiag`` (cspline.c:212), by ``lax.scan``
Thomas sweeps.  Here the sweeps are ``kernels/csrc/tridiag.cu``: one thread
per right-hand side, m right-hand sides sharing the matrix in an [n, m]
layout (``interp2d`` solves every row or column of a grid in one launch).

Two routes solve the same systems, each a CUDA kernel with its plain
version beside it:

* the sequential route, :func:`thomas` (:func:`thomas_cuda`,
  :func:`thomas_ref`): one thread walks all n rows of a column;
* the partitioned route, :func:`partitioned` (:func:`partitioned_cuda`,
  :func:`partitioned_ref`): every ``BLOCK``-th row is a separator, the
  ``BLOCK - 1`` rows between two separators are eliminated by one thread
  each, the separators form a symmetric tridiagonal system of about
  n / ``BLOCK`` rows, solved the same way until it has at most ``BLOCK``
  rows (the sequential route finishes it), and the interior rows are filled
  in from their separators.

:func:`solve_symm_tridiag` and :func:`solve_symm_cyc_tridiag` take the
partitioned route above ``PARTITION_MIN_ROWS`` rows.  Both the block length
and the route depend on n alone, so a column solved inside ``[n, m]``
equals its solve alone, bit for bit.  On a CUDA tensor a dispatcher
launches the kernel and raises if it cannot; on a CPU tensor it runs the
plain version, which the kernel (built with ``-fmad=false``) equals bit for
bit.
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
# The partitioned route's block: every BLOCK-th row is a separator
# (kBlock in kernels/csrc/tridiag.cu, which must equal it).  On an H100
# (700 W, float64 device times of tools/tridiag_routes.py, the kernels as
# they were before the shared-memory tiles, built for 16, 32 and 64) 32
# was the fastest or within 6 % of it at the main path's shapes: 0.129 ms at n = 10^6, m = 1 (16: 0.129, 64: 0.167),
# 0.140 ms at m = 2, 0.091 ms at n = 2,046, m = 2,048 (16: 0.088, 64:
# 0.086).
BLOCK = 32
# Rows above which solve_symm_tridiag takes the partitioned route.  Same
# card and tool: at 64 rows the sequential kernel is ahead (0.0172 against
# 0.0189 ms, one launch against five); at 256 the partitioned route is 3.1x
# faster on the device (0.0198 against 0.0619 ms) and 1.3x in back-to-back
# wall time.  The sequential time grows 0.23 us per row, so the device
# crossover is near 75 rows, and with the partitioned route's extra host
# cost (about 0.03 ms a call) near 170: 128 lies between.
PARTITION_MIN_ROWS = 128


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


def _check_args(name, diag, offdiag, rhs):
    """(n, m) of contiguous CUDA float32 or float64 diag [n], offdiag
    [n-1], rhs [n, m], or InvalidArgumentError."""
    dev = rhs.device
    if dev.type != "cuda":
        raise errors.InvalidArgumentError(f"{name} needs CUDA tensors")
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
    return n, m


def thomas_cuda(diag, offdiag, rhs):
    """Launch the kernel: x [n, m] on the card for contiguous float32 or
    float64 ``diag`` [n], ``offdiag`` [n-1] and ``rhs`` [n, m].

    Adds one to ``thomas_cuda.launches`` for each launch.
    """
    n, m = _check_args("thomas_cuda", diag, offdiag, rhs)
    dev, dtype = rhs.device, rhs.dtype
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


def _padded(diag, offdiag, rhs, rows):
    """diag, offdiag and rhs grown to ``rows`` rows: padding rows have
    diagonal 1, no coupling (offdiag 0 from row n-1 on) and rhs 0, so
    their solution is 0 and they leave the real rows' arithmetic alone."""
    n = diag.shape[0]
    d = torch.ones(rows, dtype=diag.dtype, device=diag.device)
    d[:n] = diag
    e = torch.zeros(rows, dtype=diag.dtype, device=diag.device)
    e[: n - 1] = offdiag
    b = torch.zeros((rows, rhs.shape[1]), dtype=rhs.dtype, device=rhs.device)
    b[:n] = rhs
    return d, e, b


def partition_plan(n: int):
    """Row counts of the levels: n, then each reduced system's
    ceil(rows / BLOCK), down to the first at most ``BLOCK`` rows, which the
    sequential route solves."""
    levels = [n]
    while levels[-1] > BLOCK:
        levels.append(-(-levels[-1] // BLOCK))
    return levels


def kernels_per_solve(n: int, m: int) -> int:
    """CUDA kernels :func:`partitioned_cuda` launches for an [n, m]
    solve: per level factor, sweep, assembly and back-fill (for m of 1 or
    2 the factor and the sweep are one kernel), then the sequential
    kernel."""
    return (3 if m <= 2 else 4) * (len(partition_plan(n)) - 1) + 1


def partitioned_ref(diag, offdiag, rhs):
    """Plain version of the partitioned route: x [n, m] with ``A x = rhs``
    (arguments as :func:`thomas_ref`), in the kernel's order of operations,
    vectorised over blocks and columns.

    One level, with nb = ceil(n / BLOCK) blocks on the system padded to
    nb * BLOCK rows (:func:`_padded`); block k holds interior rows
    k*BLOCK + j, j < BLOCK - 1, and the separator k*BLOCK + BLOCK - 1:

    * factor (one per block, shared by the columns): with ``ep`` the
      previous interior row's offdiag (0 at j = 0),
      ``r = 1 / (d - ep * c_prev)``, ``c = e * r``, and the left spike's
      forward ``h = (eL - ep * h_prev) * r``, eL (the coupling to the
      left separator, 0 for block 0) only at j = 0; back from the last
      interior row, ``vL = h - c * vL_next`` (vL = h there) and
      ``vR = -(c * vR_next)`` (vR = c there);
    * sweep (one per block and column): ``g = (b - ep * g_prev) * r``,
      then ``y = g - c * y_next`` (y = g at the last interior row);
    * the reduced system on the separators, with eR = the last interior
      row's offdiag and eS = the separator's own:
      ``D = (d_s - eR * vR_last) - eS * vL_next_first``,
      ``E = -(eS * vR_next_first)``,
      ``B = (b_s - eR * y_last) - eS * y_next_first`` (next block's terms 0
      past the last block), solved by this function again, or by
      :func:`thomas_ref` once it has at most ``BLOCK`` rows;
    * back-fill: ``x = (y - X_left * vL) - X_right * vR`` in the interior
      (X_left = 0 for block 0), ``x = X`` at the separators.
    """
    n, m = rhs.shape
    if n <= BLOCK:
        return thomas_ref(diag, offdiag, rhs)
    nb = -(-n // BLOCK)
    w = BLOCK - 1
    d, e, b = _padded(diag, offdiag, rhs, nb * BLOCK)
    d, e, b = d.view(nb, BLOCK), e.view(nb, BLOCK), b.view(nb, BLOCK, m)
    zero = torch.zeros(nb, dtype=d.dtype, device=d.device)
    e_left = torch.cat([zero[:1], e[:-1, w]])  # eL: row k*block - 1's offdiag
    # Factor.
    rs, cs, hs = [], [], []
    c_prev, h_prev, e_prev = zero, zero, zero
    for j in range(w):
        r = torch.ones_like(zero) / (d[:, j] - e_prev * c_prev)
        c_prev = e[:, j] * r
        h_prev = ((e_left if j == 0 else zero) - e_prev * h_prev) * r
        rs.append(r)
        cs.append(c_prev)
        hs.append(h_prev)
        e_prev = e[:, j]
    vl, vr = [None] * w, [None] * w
    vl[w - 1], vr[w - 1] = hs[w - 1], cs[w - 1]
    for j in range(w - 2, -1, -1):
        vl[j] = hs[j] - cs[j] * vl[j + 1]
        vr[j] = -(cs[j] * vr[j + 1])
    # Sweep.
    g_prev, e_prev = torch.zeros_like(b[:, 0]), zero
    gs = []
    for j in range(w):
        g_prev = (b[:, j] - e_prev[:, None] * g_prev) * rs[j][:, None]
        gs.append(g_prev)
        e_prev = e[:, j]
    ys = [None] * w
    ys[w - 1] = gs[w - 1]
    for j in range(w - 2, -1, -1):
        ys[j] = gs[j] - cs[j][:, None] * ys[j + 1]
    # The reduced system.
    e_r, e_s = e[:, w - 1], e[:, w]
    vl_next = torch.cat([vl[0][1:], zero[:1]])
    y_next = torch.cat([ys[0][1:], torch.zeros_like(ys[0][:1])])
    red_d = (d[:, w] - e_r * vr[w - 1]) - e_s * vl_next
    red_e = -(e_s[:-1] * vr[0][1:])
    red_b = (b[:, w] - e_r[:, None] * ys[w - 1]) - e_s[:, None] * y_next
    xs = partitioned_ref(red_d, red_e, red_b)
    # Back-fill.
    x_left = torch.cat([torch.zeros_like(xs[:1]), xs[:-1]])
    y = torch.stack(ys, 1)
    x = (y - x_left[:, None] * torch.stack(vl, 1)[:, :, None]) \
        - xs[:, None] * torch.stack(vr, 1)[:, :, None]
    return torch.cat([x, xs[:, None]], 1).reshape(nb * BLOCK, m)[:n]


def partitioned_cuda(diag, offdiag, rhs):
    """Launch the partitioned route: x [n, m] on the card (arguments as
    :func:`thomas_cuda`), :func:`kernels_per_solve` kernels on the current
    stream.

    Adds one to ``partitioned_cuda.launches`` for each solve and the
    number of kernels it launched to ``partitioned_cuda.kernel_launches``.
    """
    n, m = _check_args("partitioned_cuda", diag, offdiag, rhs)
    x = torch.empty_like(rhs)
    if n == 0 or m == 0:
        return x
    sizer, fn = _part_launcher()
    elems = sizer(n, m)
    scratch = torch.empty(elems, dtype=rhs.dtype, device=rhs.device)
    launched = ctypes.c_int(0)
    with torch.cuda.device(rhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(diag.data_ptr(), offdiag.data_ptr(), rhs.data_ptr(),
                 x.data_ptr(), scratch.data_ptr(), elems, n, m,
                 int(rhs.dtype == torch.float64), ctypes.byref(launched), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} partitioned launch failed with error {err}")
    partitioned_cuda.launches += 1
    partitioned_cuda.kernel_launches += launched.value
    return x


partitioned_cuda.launches = 0
partitioned_cuda.kernel_launches = 0


def _part_launcher():
    lib = build.load(KERNEL)
    sizer, fn = lib.tridiag_part_scratch, lib.tridiag_part_launch
    sizer.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    sizer.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return sizer, fn


def _dispatch(cuda_fn, ref_fn, diag, offdiag, rhs):
    dev = rhs.device.type
    if dev == "cuda":
        return cuda_fn(diag.contiguous(), offdiag.contiguous(), rhs.contiguous())
    if dev == "cpu":
        return ref_fn(diag, offdiag, rhs)
    raise errors.InvalidArgumentError(f"no tridiag kernel for {rhs.device}")


def thomas(diag, offdiag, rhs):
    """x [n, m] by the sequential route: the Hopper kernel for CUDA
    tensors, the plain version for CPU tensors (arguments as
    :func:`thomas_ref`)."""
    return _dispatch(thomas_cuda, thomas_ref, diag, offdiag, rhs)


def partitioned(diag, offdiag, rhs):
    """x [n, m] by the partitioned route: the Hopper kernels for CUDA
    tensors, the plain version for CPU tensors."""
    return _dispatch(partitioned_cuda, partitioned_ref, diag, offdiag, rhs)


def solve_rows(diag, offdiag, rhs):
    """x [n, m] by the route for n rows: partitioned above
    ``PARTITION_MIN_ROWS``, sequential at and below it."""
    route = partitioned if diag.shape[0] > PARTITION_MIN_ROWS else thomas
    return route(diag, offdiag, rhs)


def solve_symm_tridiag(diag, offdiag, rhs):
    """Solve the symmetric tridiagonal ``A x = rhs``.

    diag [n], offdiag [n-1] (sub == super), rhs [n] or [n, m] (m systems
    that share A); x has rhs's shape.
    """
    n = diag.shape[0]
    if n == 1:
        return rhs / (diag if rhs.dim() == 1 else diag[:, None])
    x = solve_rows(diag, offdiag, rhs if rhs.dim() == 2 else rhs[:, None])
    return x if rhs.dim() == 2 else x[:, 0]


def solve_symm_cyc_tridiag(diag, offdiag, rhs):
    """Solve the symmetric cyclic tridiagonal ``A x = rhs`` by
    Sherman-Morrison, as JAX does (``ops/tridiag.py:53-77``).

    diag [n], offdiag [n] (offdiag[n-1] couples row n-1 with row 0),
    rhs [n].  The two solves with the modified diagonal, y and z, are one
    solve with m = 2.
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
    yz = solve_rows(dmod, offdiag[:-1], torch.stack([rhs, u], dim=-1))
    y, z = yz[:, 0], yz[:, 1]
    factor = (v @ y) / (1.0 + v @ z)
    return y - factor * z
