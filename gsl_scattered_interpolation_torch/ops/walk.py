"""The 2D cell route's walk fallback: the Hopper kernel's wrapper.

:func:`walk2d_cuda` launches ``kernels/csrc/walk2d.cu``, which walks each
float32 query that ``device_tri.locate_cells`` could not settle from its
cell's hint to its end, one thread a query, and writes its leaf, weights and
``in_domain`` into the batch's arrays, or in value mode its value alone
(the tail of ``device_tri.interp``, as the cell kernel's value mode writes
it).  Its plain version is the lockstep loop of
``models/device_tri.py::locate``, which ``locate_cells`` takes off the
card, for float64 queries and in 3D; the two agree to the bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels import build
from ..utils import errors, machine
from .cells import check_resp_rows

KERNEL = "walk2d"
# The walk's float32 slack: device_tri.locate's default for float32 queries.
TOL = 16.0 * machine.eps(torch.float32)


def walk2d_cuda(q, idx, shift, scale, hint, res: int, nbrs, affine, max_steps: int,
                leaf, w, in_domain, values=None):
    """Walk rows ``idx`` (int64 [M]) of the raw float32 queries q [B, 2] on
    the card, each from the hint (``hint`` [res^2] int32) of its cell of
    the float32 triangulation (``shift``, ``scale`` [2], ``nbrs`` [T, 3]
    int32, ``affine`` [T, 8]) for at most ``max_steps`` steps, as
    ``device_tri.locate`` with its default slack does.  Writes each walked
    row's leaf (``leaf`` int64 [B]), weights (``w`` float32 [B, 3]) and
    ``in_domain`` (bool [B], with ``locate_cells``'s every weight > -0.5)
    in place.  With ``values`` = (resp_rows, vals float32 [B]),
    ``resp_rows`` the triangles' response rows
    (``device_tri.vertex_responses``, [T, 4] float32), the value mode:
    ``leaf``, ``w`` and ``in_domain`` are None, and each walked row's value
    goes to ``vals`` instead, as ``device_tri.interp`` forms it.  Returns
    an int32 [1] tensor on the card: the largest iteration count,
    ``max_steps + 1`` where a query never stopped, 0 for M = 0.  Adds one
    to ``walk2d_cuda.launches``.
    """
    if q.device.type != "cuda":
        raise errors.InvalidArgumentError("walk2d_cuda needs CUDA tensors")
    B, M, T, dev = q.shape[0], idx.shape[0], affine.shape[0], q.device
    build.check_arg("q", q, (B, 2), torch.float32, dev)
    build.check_arg("idx", idx, (M,), torch.int64, dev)
    build.check_arg("shift", shift, (2,), torch.float32, dev)
    build.check_arg("scale", scale, (2,), torch.float32, dev)
    build.check_arg("hint", hint, (res * res,), torch.int32, dev)
    build.check_arg("nbrs", nbrs, (T, 3), torch.int32, dev)
    build.check_arg("affine", affine, (T, 8), torch.float32, dev)
    if values is None:
        build.check_arg("leaf", leaf, (B,), torch.int64, dev)
        build.check_arg("w", w, (B, 3), torch.float32, dev)
        build.check_arg("in_domain", in_domain, (B,), torch.bool, dev)
        # The launcher's resp_rows, leaf, w, in_domain and vals, None for null.
        outs = (None, leaf, w, in_domain, None)
    else:
        resp_rows, vals = values
        if leaf is not None or w is not None or in_domain is not None:
            raise errors.InvalidArgumentError("the value mode takes no leaf, w or in_domain")
        check_resp_rows(resp_rows, T, dev)
        build.check_arg("vals", vals, (B,), torch.float32, dev)
        outs = (resp_rows, None, None, None, vals)
    if q.data_ptr() % 8 or affine.data_ptr() % 16:
        raise errors.InvalidArgumentError("q must be 8-byte and affine 16-byte aligned")
    if not 0 <= max_steps < 2**30 or M >= 2**31 - 128 or T >= 2**31:
        raise errors.InvalidArgumentError(f"unsupported sizes M={M}, T={T}, max_steps={max_steps}")
    n_max = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(q.data_ptr(), idx.data_ptr(), M, shift.data_ptr(), scale.data_ptr(),
                          hint.data_ptr(), res, nbrs.data_ptr(), affine.data_ptr(),
                          max_steps, TOL,
                          *(None if t is None else t.data_ptr() for t in outs),
                          n_max.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    walk2d_cuda.launches += 1
    return n_max


walk2d_cuda.launches = 0


@functools.cache
def _launcher():
    fn = build.load(KERNEL).walk2d_launch
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int
    return fn
