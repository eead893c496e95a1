"""2D point location by the cell index: the Hopper kernel's wrapper.

:func:`cells2d_cuda` launches ``kernels/csrc/cells2d.cu``, which scores
each float32 query's cell candidates and returns the leaf, its weights,
``in_domain`` and the walk mask in one pass over the query's row.  Its
plain version is ``models/device_tri.py::_locate_cells_score_2d``, the
torch code that ``device_tri.locate_cells`` takes off the card and for
float64 queries; the two agree to the bit.  In value mode, which
``device_tri.interp_cells_on_card`` takes, the kernel returns each query's
value (the tail of ``device_tri.interp``, to the bit) and the walk mask
instead.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..kernels import build
from ..utils import errors, machine

KERNEL = "cells2d"
# The float32 slack of the score and of the weights, as torch rounds the
# Python scalar that locate_cells compares against.
TOL = float(np.float32(-4.0 * machine.sqrt_eps(torch.float32)))


def cells2d_cuda(q, shift, scale, table, overflow, affine, res: int, k: int,
                 complete: bool, values=None):
    """Launch the kernel on raw float32 queries q [B, 2] against a 2D cell
    index (``table`` [res^2, 7k] float32, ``overflow`` [res^2] bool,
    ``complete``) of a float32 triangulation (``shift``, ``scale`` [2],
    ``affine`` [T, 8]).  Returns (leaf int64 [B], weights float32 [B, 3],
    in_domain bool [B], bad bool [B]), ``bad`` being the queries that
    ``locate_cells`` walks.  With ``values``, the triangles' response rows
    (``device_tri.vertex_responses``, [T, 4] float32), the value mode:
    returns (vals float32 [B], bad), ``vals`` being ``device_tri.interp``'s
    values of the queries not to walk.  Adds one to
    ``cells2d_cuda.launches``.
    """
    if q.device.type != "cuda":
        raise errors.InvalidArgumentError("cells2d_cuda needs CUDA tensors")
    B, cells, T = q.shape[0], res * res, affine.shape[0]
    dev = q.device
    build.check_arg("q", q, (B, 2), torch.float32, dev)
    build.check_arg("shift", shift, (2,), torch.float32, dev)
    build.check_arg("scale", scale, (2,), torch.float32, dev)
    build.check_arg("table", table, (cells, 7 * k), torch.float32, dev)
    build.check_arg("overflow", overflow, (cells,), torch.bool, dev)
    build.check_arg("affine", affine, (T, 8), torch.float32, dev)
    if q.data_ptr() % 8 or affine.data_ptr() % 16:
        raise errors.InvalidArgumentError("q must be 8-byte and affine 16-byte aligned")
    if k < 1 or B >= 2**31 - 16 or T >= 2**24:  # int32 query index, exact float ids
        raise errors.InvalidArgumentError(f"unsupported sizes B={B}, K={k}, T={T}")
    # The launcher's resp_rows, leaf, w, in_domain and vals, None for null.
    if values is None:
        outs = (None, torch.empty(B, dtype=torch.int64, device=dev),
                torch.empty(B, 3, dtype=torch.float32, device=dev),
                torch.empty(B, dtype=torch.bool, device=dev), None)
    else:
        check_resp_rows(values, T, dev)
        outs = (values, None, None, None, torch.empty(B, dtype=torch.float32, device=dev))
    bad = torch.empty(B, dtype=torch.bool, device=dev)
    results = tuple(t for t in outs[1:] if t is not None) + (bad,)
    if B == 0:
        return results
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(q.data_ptr(), shift.data_ptr(), scale.data_ptr(),
                          table.data_ptr(), overflow.data_ptr(), affine.data_ptr(),
                          B, res, k, int(complete), TOL,
                          *(None if t is None else t.data_ptr() for t in outs),
                          bad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    cells2d_cuda.launches += 1
    return results


cells2d_cuda.launches = 0


def check_resp_rows(resp_rows, T: int, device) -> None:
    """Raise InvalidArgumentError unless ``resp_rows``, what a value mode
    reads, is a contiguous [T, 4] float32 tensor on ``device``, 16-byte
    aligned."""
    build.check_arg("resp_rows", resp_rows, (T, 4), torch.float32, device)
    if resp_rows.data_ptr() % 16:
        raise errors.InvalidArgumentError("resp_rows must be 16-byte aligned")


@functools.cache
def _launcher():
    fn = build.load(KERNEL).cells2d_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float]
                   + [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int
    return fn
