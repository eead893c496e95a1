"""Dense 2D point location: the Hopper kernel and its plain version.

The counterpart of ``gsl_scattered_interpolation_tpu/ops/pallas_locate.py``.
Every query scores every triangle with the query-centred affine form
``c_k(q) = g_k . (q - shift) + b_k`` (third weight ``1 - c0 - c1``) and takes
the triangle whose smallest weight is largest.  The tables are float32 and
built exactly as the TPU kernel's are (``pallas_locate.py:104-123``).

On a CUDA tensor :func:`locate_dense_kernel` (leaves) and
:func:`locate_weights_kernel` (leaves and barycentric weights) launch the
kernel of ``kernels/csrc/locate2d.cu`` and raise if they cannot; on a CPU
tensor they run the plain versions, which repeat the kernel's arithmetic op
for op.  :func:`plan` splits the triangles into slices so that the grid
covers the card's SMs evenly; the slices of a query merge through the key
that :func:`merge_key_ref` mirrors.
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path

import torch

from ..kernels import build
from ..utils import errors

KERNEL = "locate2d"


def _source_constant(name: str) -> int:
    """``constexpr int <name> = <value>;`` of the kernel's source: the one
    definition of the launch geometry that :func:`plan` models."""
    # The path by hand: kernels.build may still be importing (its utils
    # import reaches this module).
    src = (Path(__file__).resolve().parents[1] / "kernels" / "csrc" / f"{KERNEL}.cu").read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    if m is None:
        raise RuntimeError(f"{KERNEL}.cu defines no {name}")
    return int(m.group(1))


THREADS = _source_constant("kThreads")  # a block's threads
GROUP = _source_constant("kGroup")      # triangles under one running max
ROWS = _source_constant("kRows")        # queries per thread
# The cost model of plan(): an SM needs this many resident blocks to issue
# at full rate, and a block costs this many triangles' worth of sweep on
# top of its slice (set-up, the first chunk's load, the rescan).
MIN_BLOCKS_PER_SM = 4
BLOCK_OVERHEAD_TRIS = 2 * GROUP
MAX_SLICES = 1024


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


def merge_key_ref(score, index):
    """The kernel's 64-bit merge key of float32 ``score`` and ``index``, as
    int64: the high word orders the score (-0 as +0), the low word is
    ``0xFFFFFFFF - index``.  The largest key over a query's slices is the
    first index of its largest score; the key of (-inf, 0) starts the merge.
    A plain mirror for the tests; nothing on the main path calls it."""
    s = torch.where(score == 0, torch.zeros_like(score), score)
    o = s.float().view(torch.int32).to(torch.int64)
    o = o ^ ((o >> 31) & 0x7FFFFFFF)
    return o * 2**32 + (0xFFFFFFFF - index.to(torch.int64))


def merge_key_index(key):
    """The index that a merge key carries."""
    return (0xFFFFFFFF - (key & 0xFFFFFFFF)).to(torch.int32)


# The key of (-inf, 0): high word 0x807FFFFF, low word 0xFFFFFFFF, as int64.
INITIAL_KEY = -0x7F80000000000001


@functools.lru_cache(maxsize=256)
def plan(n_q: int, n_t: int, n_sms: int):
    """(slices, slice_len) of a launch of ``n_q`` queries on ``n_t``
    triangles on a card with ``n_sms`` SMs.

    A block sweeps ``ROWS * THREADS`` queries over one slice of
    ``slice_len`` triangles (a multiple of ``GROUP``).  Its time is taken
    as ``slice_len + BLOCK_OVERHEAD_TRIS``, and an SM's as its count of
    blocks, at least ``MIN_BLOCKS_PER_SM``, times that: the split whose
    busiest SM finishes first wins, and fewer slices win within 1 %.
    """
    tiles = -(-n_q // (ROWS * THREADS))
    best = None
    for s in range(1, min(MAX_SLICES, -(-n_t // GROUP)) + 1):
        length = -(-n_t // s)
        length = -(-length // GROUP) * GROUP
        if -(-n_t // length) != s:
            continue  # the same split as fewer slices
        per_sm = max(-(-tiles * s // n_sms), MIN_BLOCKS_PER_SM)
        cost = per_sm * (length + BLOCK_OVERHEAD_TRIS)
        if best is None or cost < 0.99 * best[0]:
            best = (cost, s, length)
    return best[1], best[2]


def kernels_per_call(slices: int) -> int:
    """CUDA kernels of one launch: the sweep, and the merge pass if split."""
    return 1 if slices == 1 else 2


def locate2d_cuda(q, g_pack, b_pack, centre, affine=None):
    """Launch the kernel on raw float32 queries q [B, 2]: int32 leaves [B],
    or (leaves, float32 weights [B, 3]) when ``affine`` is given.

    The kernel centres the queries at ``centre`` ([2] float32) as
    :func:`_centred` does; tables built by hand pass zeros, which leave
    every query as it is.  ``affine`` is the triangulation's float32
    [T, 8] maps.  The grid is :func:`plan`'s.  Adds one to
    ``locate2d_cuda.launches`` for each call and the number of CUDA kernels
    it launched (:func:`kernels_per_call`) to
    ``locate2d_cuda.kernel_launches``.
    """
    if q.device.type != "cuda":
        raise errors.InvalidArgumentError("locate2d_cuda needs CUDA tensors")
    B, T = q.shape[0], g_pack.shape[-1]
    build.check_arg("q", q, (B, 2), torch.float32, q.device)
    build.check_arg("g_pack", g_pack, (4, T), torch.float32, q.device)
    build.check_arg("b_pack", b_pack, (2, T), torch.float32, q.device)
    build.check_arg("centre", centre, (2,), torch.float32, q.device)
    if affine is not None:
        build.check_arg("affine", affine, (T, 8), torch.float32, q.device)
    if T < 1 or B >= 2**30 or 8 * T >= 2**31:  # int32 offsets in the kernel
        raise errors.InvalidArgumentError(f"unsupported sizes B={B}, T={T}")
    leaf = torch.empty(B, dtype=torch.int32, device=q.device)
    w = None if affine is None else torch.empty(B, 3, dtype=torch.float32, device=q.device)
    if B == 0:
        return leaf if w is None else (leaf, w)
    slices, slice_len = plan(B, T, _sm_count(q.device.index))
    keys = None
    if slices > 1:
        keys = torch.empty(B, dtype=torch.int64, device=q.device).fill_(INITIAL_KEY)
    fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), centre.data_ptr(), g_pack.data_ptr(), b_pack.data_ptr(),
                 _ptr(affine), B, T, slices, slice_len, _ptr(keys),
                 leaf.data_ptr(), _ptr(w), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    locate2d_cuda.launches += 1
    locate2d_cuda.kernel_launches += kernels_per_call(slices)
    return leaf if w is None else (leaf, w)


locate2d_cuda.launches = 0
locate2d_cuda.kernel_launches = 0


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launcher():
    fn = build.load(KERNEL).locate2d_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


def _centred(q_raw, centre):
    return (q_raw.float() - centre).contiguous()


def locate_dense_kernel(tri, q_raw):
    """Best triangle [B] (int32) for raw queries [B, 2] by brute force.

    The counterpart of ``pallas_locate.locate_dense_pallas``: the Hopper
    kernel for CUDA tensors, its plain version for CPU tensors.  Use
    :func:`locate_weights_kernel` for the weights as well.
    """
    centre, g_pack, b_pack = tri.locate_tables
    if q_raw.device.type == "cuda":
        return locate2d_cuda(q_raw.float().contiguous(), g_pack, b_pack, centre)
    if q_raw.device.type == "cpu":
        return locate2d_ref(_centred(q_raw, centre), g_pack, b_pack)
    raise errors.InvalidArgumentError(f"no locate kernel for {q_raw.device}")


def locate_weights_kernel(tri, q_raw):
    """(leaf int32 [B], weights [B, 3]) for raw queries [B, 2]: the
    leaves of :func:`locate_dense_kernel` and ``device_tri._weights`` of
    them, in one launch.

    For a float32 triangulation and float32 queries on the card the kernel
    emits the weights, each operation rounded as ``_weights`` rounds it.
    Otherwise ``_weights`` follows :func:`locate_dense_kernel`: on the card
    for a float64 triangulation (whose tables are float32; its weights stay
    float64), and on the CPU as the plain version.
    """
    from ..models.device_tri import _weights  # device_tri imports this module

    if q_raw.device.type == "cuda" and tri.affine.dtype == q_raw.dtype == torch.float32:
        centre, g_pack, b_pack = tri.locate_tables
        return locate2d_cuda(q_raw.contiguous(), g_pack, b_pack, centre,
                             affine=tri.affine.contiguous())
    leaf = locate_dense_kernel(tri, q_raw)
    return leaf, _weights(tri, leaf, q_raw)


def locate_dense_ref(tri, q_raw):
    """:func:`locate_dense_kernel` through the plain version on any device."""
    centre, g_pack, b_pack = tri.locate_tables
    return locate2d_ref(_centred(q_raw, centre), g_pack, b_pack)
