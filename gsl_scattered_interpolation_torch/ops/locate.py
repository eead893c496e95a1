"""Dense 2D point location: the Hopper kernel and its plain version.

The counterpart of ``gsl_scattered_interpolation_tpu/ops/pallas_locate.py``.
Every query scores every triangle with the query-centred affine form
``c_k(q) = g_k . (q - shift) + b_k`` (third weight ``1 - c0 - c1``) and takes
the triangle whose smallest weight is largest.  The tables are float32 and
built exactly as the TPU kernel's are (``pallas_locate.py:104-123``).

On a CUDA tensor :func:`locate_dense_kernel` launches the kernel of
``kernels/csrc/locate2d.cu`` and raises if it cannot; on a CPU tensor it
runs the plain version, which repeats the kernel's arithmetic op for op.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build
from ..utils import errors

KERNEL = "locate2d"


def pack_tables(tri):
    """(centre [2], g_pack [4, T], b_pack [2, T]), float32, on tri's device.

    ``g_pack`` rows are ``g0x g0y g1x g1y`` and ``b_pack`` rows ``b0 b1``:
    ``c_k(q) = A[k] . (q - centre) + (w0[k] + A[k] . (centre - anchor))``.
    """
    if tri.dim != 2:
        raise errors.InvalidArgumentError("dense locate kernel is 2D")
    T = tri.n_tris
    A = tri.affine[:, :4].reshape(T, 2, 2).float()
    anchor = tri.affine[:, 4:6].float()
    w0 = tri.affine[:, 6:].float()
    centre = tri.shift.float()
    bias = w0 + torch.sum(A * (centre - anchor)[:, None, :], dim=-1)  # [T, 2]
    g_pack = torch.cat([A[:, 0, :].T, A[:, 1, :].T], dim=0).contiguous()
    b_pack = bias.T.contiguous()
    return centre, g_pack, b_pack


def locate2d_ref(qc, g_pack, b_pack, block: int | None = None):
    """Plain PyTorch version of the kernel: int32 leaf [B] for centred qc [B, 2].

    Eager ops round one by one, as the kernel built with ``-fmad=false``
    does; ``torch.argmax`` takes the first maximum, as the kernel's strict
    '>' does.  Queries go in blocks so the [block, T] scores stay near
    1 GiB (the block formula of the JAX ``locate_dense``).
    """
    B, T = qc.shape[0], g_pack.shape[1]
    if block is None:
        block = max(512, min(65536, (1 << 28) // max(T * 2, 1)))
    out = torch.empty(B, dtype=torch.int32, device=qc.device)
    for s in range(0, B, block):
        q0 = qc[s : s + block, 0:1]
        q1 = qc[s : s + block, 1:2]
        c0 = q0 * g_pack[0] + q1 * g_pack[1] + b_pack[0]
        c1 = q0 * g_pack[2] + q1 * g_pack[3] + b_pack[1]
        score = torch.minimum(torch.minimum(c0, c1), 1.0 - c0 - c1)
        out[s : s + block] = torch.argmax(score, dim=-1)
    return out


def locate2d_cuda(qc, g_pack, b_pack):
    """Launch the kernel: int32 leaf [B] for centred float32 qc [B, 2].

    Adds one to ``locate2d_cuda.launches`` for each launch.
    """
    if qc.device.type != "cuda":
        raise errors.InvalidArgumentError("locate2d_cuda needs CUDA tensors")
    B, T = qc.shape[0], g_pack.shape[-1]
    build.check_arg("qc", qc, (B, 2), torch.float32, qc.device)
    build.check_arg("g_pack", g_pack, (4, T), torch.float32, qc.device)
    build.check_arg("b_pack", b_pack, (2, T), torch.float32, qc.device)
    if T < 1 or B >= 2**31 or 4 * T >= 2**31:  # int32 offsets in the kernel
        raise errors.InvalidArgumentError(f"unsupported sizes B={B}, T={T}")
    out = torch.empty(B, dtype=torch.int32, device=qc.device)
    if B == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(qc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qc.data_ptr(), g_pack.data_ptr(), b_pack.data_ptr(), B, T,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    locate2d_cuda.launches += 1
    return out


locate2d_cuda.launches = 0


def _launcher():
    fn = build.load(KERNEL).locate2d_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _centred(q_raw, centre):
    return (q_raw.float() - centre).contiguous()


def locate_dense_kernel(tri, q_raw):
    """Best triangle [B] (int32) for raw queries [B, 2] by brute force.

    The counterpart of ``pallas_locate.locate_dense_pallas``: the Hopper
    kernel for CUDA tensors, its plain version for CPU tensors.  Use
    ``models.device_tri._weights`` on the result for exact weights.
    """
    centre, g_pack, b_pack = tri.locate_tables
    qc = _centred(q_raw, centre)
    if qc.device.type == "cuda":
        return locate2d_cuda(qc, g_pack, b_pack)
    if qc.device.type == "cpu":
        return locate2d_ref(qc, g_pack, b_pack)
    raise errors.InvalidArgumentError(f"no locate kernel for {qc.device}")


def locate_dense_ref(tri, q_raw):
    """:func:`locate_dense_kernel` through the plain version on any device."""
    centre, g_pack, b_pack = tri.locate_tables
    return locate2d_ref(_centred(q_raw, centre), g_pack, b_pack)
