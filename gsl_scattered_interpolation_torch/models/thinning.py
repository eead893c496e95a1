"""Data thinning: error-bounded site decimation (reference README:29).

The counterpart of ``gsl_scattered_interpolation_tpu/models/thinning.py``:
greedy-insertion decimation (Garland-Heckbert terrain simplification)
instead of serial remove-one-and-retriangulate:

  1. keep a small random subset of the sites, plus the extremes of each
     axis so the kept triangulation covers every dropped site;
  2. triangulate it and evaluate ALL dropped sites in one batched pass;
  3. keep the worst offenders (a batch per round, growing geometrically)
     until every dropped site is reproduced within ``tol``.

At exit, for every dropped site i, |interp_kept(x_i) - v_i| <= tol.  Each
round is one build at the kept size plus one batched evaluation.  With
``builder="device"`` the build is ``device_delaunay.triangulate`` (its
flip rounds launch the candidate kernel on the card) and, for a float32
triangulation of at most ``device_tri.PALLAS_LOCATE_MAX_TRIS`` triangles
on CUDA, ``device_tri.interp`` locates through the locate kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import config, errors
from . import device_delaunay, device_tri


class ThinResult(NamedTuple):
    keep: np.ndarray       # sorted indices of kept sites
    max_error: float       # max |interp - value| over dropped sites
    rounds: int
    tri: object            # DeviceTriangulation of the kept subset
    shuffle: np.ndarray    # insertion order of the kept build


def thin(
    sites,
    values,
    tol: float,
    seed_frac: float = 1.0 / 64.0,
    growth: float = 2.0,
    max_rounds: int = 64,
    key=0,
    builder: str = "device",
    device="cuda",
    dtype=None,
) -> ThinResult:
    """Thin (sites, values) to a subset reproducing all data within tol.

    Args:
      sites: [N, d] raw coordinates, any d >= 2.
      values: [N].
      tol: absolute reproduction tolerance at dropped sites.
      seed_frac: initial kept fraction (plus the 2d bbox extremes).
      growth: per-round growth factor of the insertion batch.
      key: seed of the numpy generator that picks the initial subset.
      builder: the per-round triangulation: "device" (the native 2D build
        on ``device``) or "qhull" (scipy's Delaunay imported through
        ``geometry_extras.from_scipy_delaunay``, the only builder for
        d > 2).  Evaluation runs on ``device`` either way.
      device, dtype: where and in what precision the triangulation is
        built and evaluated (float32 on CUDA, float64 on the CPU by
        default).

    Returns ThinResult; ``keep`` indexes rows of ``sites``.
    """
    device, dtype = config.device_dtype(device, dtype)
    sites = np.asarray(sites, np.float64)
    values = np.asarray(values, np.float64)
    n, d = sites.shape
    if d != 2 and builder == "device":
        config.log.info("thin: d=%d routed to the qhull builder", d)
        builder = "qhull"
    if values.shape != (n,):
        raise errors.InvalidArgumentError("values shape mismatch")

    rng = np.random.default_rng(key)
    kept = np.zeros(n, bool)
    # Bbox extremes keep the hull wide so dropped sites stay covered
    # (fade-to-zero outside the kept hull would poison the error test).
    for ax in range(d):
        kept[np.argmin(sites[:, ax])] = True
        kept[np.argmax(sites[:, ax])] = True
    n_seed = max(4, int(n * seed_frac))
    kept[rng.choice(n, size=n_seed, replace=False)] = True

    batch = max(8, n_seed // 4)
    rounds = 0
    max_err = np.inf
    tri = shuffle = None
    while rounds < max_rounds:
        rounds += 1
        keep_idx = np.nonzero(kept)[0]
        if builder == "qhull":
            from scipy.spatial import Delaunay

            from . import geometry_extras

            tri = geometry_extras.from_scipy_delaunay(
                Delaunay(sites[keep_idx]), sites[keep_idx], grid_res=64,
                device=device,
            )
            shuffle = np.arange(keep_idx.size)
        else:
            tri, shuffle = device_delaunay.triangulate(
                sites[keep_idx], key=None, dtype=dtype, device=device
            )
        tri = tri.cast(dtype)
        resp = device_tri.response_for_build(
            shuffle, values[keep_idx], d=d, device=device
        ).to(dtype)
        drop_idx = np.nonzero(~kept)[0]
        if drop_idx.size == 0:
            max_err = 0.0
            break
        q = torch.as_tensor(sites[drop_idx], dtype=dtype, device=device)
        est = device_tri.interp(tri, resp, q).double().cpu().numpy()
        err = np.abs(est - values[drop_idx])
        max_err = float(err.max())
        if max_err <= tol:
            break
        worst = np.argsort(err)[::-1]
        bad = worst[err[worst] > tol][:batch]
        kept[drop_idx[bad]] = True
        batch = int(batch * growth)
        config.log.info(
            "thin round %d: kept %d, max err %.3g",
            rounds,
            int(kept.sum()),
            max_err,
        )

    return ThinResult(
        keep=np.nonzero(kept)[0],
        max_error=max_err,
        rounds=rounds,
        tri=tri,
        shuffle=shuffle,
    )
