"""Flip-candidate verdicts of the 2D device build: the Hopper kernel and its
plain version.

The counterpart of ``gsl_scattered_interpolation_tpu/ops/pallas_candmath.py``
and of ``_edge_candidates_math`` in the JAX package's
``models/device_delaunay.py``.  For each edge e of R triangles, with apex
``a = apex3[r, e]``, shared-edge ends ``p1``/``p2`` (the ``(e+1)%3`` and
``(e+2)%3`` entries of the row) and far vertex ``f = fq3[r, e]`` across the
edge, the verdict is:

1. convex: ``sign(orient2d_ds(a, f, p1)) * sign(orient2d_ds(a, f, p2)) < 0``;
2. the quad's four (id, x, y) triples sorted by id with a 5-comparator
   network;
3. ``S = incircle_ds(sorted) * sign(orient2d_ds(sorted[:3]))``, the same
   number from both sides of the edge;
4. ``want``: flip iff S > 0 and the largest id sits on the flip diagonal,
   or S < 0 and it does not;
5. ``valid & convex & (want | degenerate own | degenerate neighbour)``.

On a CUDA tensor :func:`edge_candidates_math` launches the kernel of
``kernels/csrc/candmath2d.cu`` and raises if it cannot; on a CPU tensor it
runs :func:`edge_candidates_math_ref`, which is eager PyTorch on
``ops/robust.py`` and rounds op by op, as the kernel (built with
``-fmad=false``) does.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import build
from ..utils import errors
from . import robust

KERNEL = "candmath2d"

# Operations per edge, counted from the kernel's source with each distinct
# value computed once and only what the verdict uses (the kernel's inlined
# helpers repeat pure expressions, which the compiler folds: a square
# splits its value once, a quantity squared in one place and multiplied in
# another is split once; the error term of each predicate's last two-sum
# is dropped).  Float: a compensated orient2d takes 87 adds and
# multiplies, the compensated incircle 464 (tests/test_torch_candmath.py
# traces both), and the signs and the verdict 11 more (6 compares for
# three signs, 2 multiplies, 3 compares).  Integer and select: the sort
# network 35 (5 compares, 30 selects), the largest-id rule 7, the sign
# selects and the boolean verdict 16.  chip_smoke.py divides them by the
# card's rates.
ORIENT2D_OPS = 87
INCIRCLE_OPS = 464
FLOAT_OPS_PER_EDGE = 3 * ORIENT2D_OPS + INCIRCLE_OPS + 11
OTHER_OPS_PER_EDGE = 35 + 7 + 16


def edge_candidates_math_ref(
    apex3, fq3, tv, p1_id, far3, p2_id, valid3, cok, degen_u
):
    """Plain version: ``cand_ok [R, 3]`` bool.

    Same arguments as the JAX ``_edge_candidates_math``: ``apex3``/``fq3``
    [R, 3, 2] float, ``tv``/``p1_id``/``far3``/``p2_id`` [R, 3] int32 with
    ``p1_id``/``p2_id`` the rolls of ``tv`` by -1 and -2, ``valid3`` and
    ``degen_u`` [R, 3] bool, ``cok`` [R] bool.
    """
    p1q = torch.roll(apex3, -1, dims=1)
    p2q = torch.roll(apex3, -2, dims=1)
    o1 = robust.orient2d_ds(apex3, fq3, p1q)
    o2 = robust.orient2d_ds(apex3, fq3, p2q)
    convex3 = torch.sign(o1) * torch.sign(o2) < 0
    # Cyclic order (apex, p1, far, p2): the current diagonal is positions
    # (1, 3), the flip target (0, 2).
    ids = [tv, p1_id, far3, p2_id]
    xs = [apex3[..., 0], p1q[..., 0], fq3[..., 0], p2q[..., 0]]
    ys = [apex3[..., 1], p1q[..., 1], fq3[..., 1], p2q[..., 1]]
    for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
        sw = ids[i] > ids[j]
        for arr in (ids, xs, ys):
            lo = torch.where(sw, arr[j], arr[i])
            hi = torch.where(sw, arr[i], arr[j])
            arr[i], arr[j] = lo, hi
    sp = [torch.stack([xs[k], ys[k]], dim=-1) for k in range(4)]
    O = robust.orient2d_ds(sp[0], sp[1], sp[2])
    S = robust.incircle_ds(sp[0], sp[1], sp[2], sp[3]) * torch.sign(O)
    quad = torch.stack([tv, p1_id, far3, p2_id], dim=-1)  # [R, 3, 4] ids
    p3 = torch.argmax(quad, dim=-1)  # the first maximum
    p3_on_flip_diag = (p3 == 0) | (p3 == 2)
    want = torch.where(S > 0, p3_on_flip_diag, ~p3_on_flip_diag)
    want = want & (S != 0)
    # Degenerate (zero-area) triangles are always flipped away
    # (linear_simplex.c:517-521).
    degen_t = ~cok[:, None]
    return valid3 & convex3 & (want | degen_t | degen_u)


def edge_candidates_math_cuda(apex3, fq3, tv, far3, valid3, cok, degen_u):
    """Launch the kernel: ``cand_ok [R, 3]`` bool on the card.

    The arguments of :func:`edge_candidates_math_ref` without ``p1_id`` and
    ``p2_id``, which the kernel reads from ``tv``.  Coordinates are float32
    or float64.  Adds one to ``edge_candidates_math_cuda.launches`` for
    each launch.
    """
    dev = apex3.device
    if dev.type != "cuda":
        raise errors.InvalidArgumentError(
            "edge_candidates_math_cuda needs CUDA tensors"
        )
    R = apex3.shape[0]
    dtype = apex3.dtype
    if dtype not in (torch.float32, torch.float64):
        raise errors.InvalidArgumentError(f"unsupported dtype {dtype}")
    build.check_arg("apex3", apex3, (R, 3, 2), dtype, dev)
    build.check_arg("fq3", fq3, (R, 3, 2), dtype, dev)
    build.check_arg("tv", tv, (R, 3), torch.int32, dev)
    build.check_arg("far3", far3, (R, 3), torch.int32, dev)
    build.check_arg("valid3", valid3, (R, 3), torch.bool, dev)
    build.check_arg("cok", cok, (R,), torch.bool, dev)
    build.check_arg("degen_u", degen_u, (R, 3), torch.bool, dev)
    if 6 * R >= 2**31:  # int32 offsets in the kernel
        raise errors.InvalidArgumentError(f"unsupported size R={R}")
    out = torch.empty((R, 3), dtype=torch.uint8, device=dev)
    if R == 0:
        return out.view(torch.bool)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(apex3.data_ptr(), fq3.data_ptr(), tv.data_ptr(),
                 far3.data_ptr(), valid3.data_ptr(), cok.data_ptr(),
                 degen_u.data_ptr(), R, int(dtype == torch.float64),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed with CUDA error {err}")
    edge_candidates_math_cuda.launches += 1
    return out.view(torch.bool)


edge_candidates_math_cuda.launches = 0


def _launcher():
    fn = build.load(KERNEL).candmath2d_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return fn


def edge_candidates_math(
    apex3, fq3, tv, p1_id, far3, p2_id, valid3, cok, degen_u
):
    """``cand_ok [R, 3]``: the Hopper kernel for CUDA tensors, the plain
    version for CPU tensors (arguments as :func:`edge_candidates_math_ref`)."""
    dev = apex3.device.type
    if dev == "cuda":
        return edge_candidates_math_cuda(
            apex3.contiguous(), fq3.contiguous(), tv.contiguous(),
            far3.contiguous(), valid3.contiguous(), cok.contiguous(),
            degen_u.contiguous(),
        )
    if dev == "cpu":
        return edge_candidates_math_ref(
            apex3, fq3, tv, p1_id, far3, p2_id, valid3, cok, degen_u
        )
    raise errors.InvalidArgumentError(f"no candmath kernel for {apex3.device}")
