"""The 3D cavity build's Qhull seed, the JAX package's and the port's, on
the CPU.

Builds bench.py's cavity3d_10k sites (``--sites`` uniform sites from
``default_rng(--seed)``, NOSTANDARDIZE) in ``--dtype`` three ways: the JAX
package's ``device_cavity.triangulate``, the port's with its seed check
turned off (the seed as JAX imports it), and the port's as it is.  For
each it evaluates bench.py's 3D test function at 20,000 queries in
[-0.45, 0.45]^3 (drawn after the sites, as bench.py does) by the walk and
holds it against scipy's ``LinearNDInterpolator`` of the same sites.
Prints one JSON line: the build seconds, the sites left out of the seed,
the largest difference from scipy and the number of queries past 1e-9, the
data tetrahedra that only the build or only scipy has, whether JAX's build
and the unchecked port's are the same set of tetrahedra, and how many
points of JAX's seed ``_seed_violations`` finds.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/cavity_seed_parity.py --sites 10000 --dtype f64

Set ``GSI_TPU_CACHE_DIR`` to a scratch directory so the JAX import leaves
the checkout alone.
"""

import argparse
import json
import time

import numpy as np
import torch

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
from scipy.interpolate import LinearNDInterpolator  # noqa: E402
from scipy.spatial import Delaunay  # noqa: E402

from gsl_scattered_interpolation_tpu.models import device_cavity as jdc  # noqa: E402
from gsl_scattered_interpolation_tpu.models import device_tri as jdt  # noqa: E402

from gsl_scattered_interpolation_torch.models import device_cavity as dc  # noqa: E402
from gsl_scattered_interpolation_torch.models import device_delaunay as dd  # noqa: E402
from gsl_scattered_interpolation_torch.models import device_tri as dt  # noqa: E402
from gsl_scattered_interpolation_torch.models import host_tree  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}


def _canon(tv):
    return {tuple(sorted(r)) for r in np.asarray(tv).tolist()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sites", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="f64")
    args = ap.parse_args()
    jdtype, dtype = DTYPES[args.dtype]
    rng = np.random.default_rng(args.seed)
    sites = rng.uniform(-0.5, 0.5, size=(args.sites, 3))
    q = rng.uniform(-0.45, 0.45, size=(20_000, 3))
    vals = np.sin(3 * sites[:, 0]) * np.cos(2 * sites[:, 1]) + sites[:, 2]
    own = sites.astype(np.float32).astype(np.float64) if args.dtype == "f32" else sites
    scipy_tri = Delaunay(own)
    ref = LinearNDInterpolator(scipy_tri, vals)(q)
    inside = np.isfinite(ref)
    theirs = _canon(scipy_tri.simplices)
    out = {"sites": args.sites, "dtype": args.dtype}

    def record(name, tv, values, secs, left_out=None):
        tv = np.asarray(tv)
        data = _canon(tv[(tv > 3).all(1)] - 4)  # key=None: user ids
        err = np.abs(values[inside] - ref[inside])
        out[name] = {"build_s": secs, "left_out": left_out,
                     "max_vs_scipy": float(err.max()),
                     "queries_past_1e-9": int((err > 1e-9).sum()),
                     "only_ours": len(data - theirs), "only_scipy": len(theirs - data)}
        return _canon(tv)

    t0 = time.perf_counter()
    jtri, jsh = jdc.triangulate(sites, flags=host_tree.NOSTANDARDIZE, dtype=jdtype)
    secs = time.perf_counter() - t0
    resp = jdt.response_for_build(jsh, vals, d=3)
    jv = np.asarray(jdt.interp(jtri, resp, jnp.asarray(q), method="walk"))
    jax_set = record("jax", jtri.tri_verts, jv, secs)

    def port(check: bool, name: str):
        saved = dc._seed_violations
        if not check:
            dc._seed_violations = lambda pts, *_: torch.zeros(0, dtype=torch.int64)
        try:
            stats = {}
            t0 = time.perf_counter()
            tri, sh = dc.triangulate(sites, flags=host_tree.NOSTANDARDIZE, dtype=dtype,
                                     device="cpu", stats=stats)
            secs = time.perf_counter() - t0
        finally:
            dc._seed_violations = saved
        resp = dt.response_for_build(sh, vals, d=3, device="cpu")
        v = dt.interp(tri, resp, torch.as_tensor(q), method="walk").numpy()
        return record(name, tri.tri_verts.numpy(), v, secs, stats["seed_left_out"])

    unchecked = port(False, "port_unchecked")
    port(True, "port")
    out["jax_equals_port_unchecked"] = jax_set == unchecked
    *_, cage, sb = dd.build_inputs(sites, flags=host_tree.NOSTANDARDIZE, dtype=dtype,
                                   jitter_ulps=0.0 if args.dtype == "f32" else float(1 << 16))
    tets0, nbrs0, _, _ = dc._qhull_seed(sb, cage, dtype, None)
    pts = torch.cat([cage, torch.as_tensor(sb, dtype=dtype)])
    out["jax_seed_violation_points"] = int(dc._seed_violations(pts, tets0, nbrs0).numel())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
