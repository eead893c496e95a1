"""The port's Qhull-seed walk against the JAX package's, on the CPU.

Builds the port's seed state of ``--sites`` uniform sites
(``default_rng(--seed)``, NOSTANDARDIZE, the build's dtype) with
``gsl_scattered_interpolation_torch.models.device_delaunay._seed_state_2d``,
captures the packed walk rows, the start triangles and the sites that its
exact walk receives, and feeds the same arrays to the JAX package's
``_pack_walk_rows`` and ``_locate_walk_exact``.  Prints one JSON line: the
sites each walk leaves unlocated (``ok`` False among those still to
insert), whether the two walks agree row for row on the leaves and on
``ok``, and, for the port's unlocated sites, whether a wider tail
workspace (``tail_div=1``) or a larger step budget (``max_steps=4096``)
locates them.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/seed_walk_parity.py --sites 1000000 --dtype f64

bench.py's 1M build is ``--sites 1000000 --seed 7``.  Set
``GSI_TPU_CACHE_DIR`` to a scratch directory so the JAX import leaves the
checkout alone.
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

from gsl_scattered_interpolation_tpu.models import device_delaunay as jdd  # noqa: E402

from gsl_scattered_interpolation_torch.models import device_delaunay as dd  # noqa: E402
from gsl_scattered_interpolation_torch.models import host_tree  # noqa: E402


def port_seed_walk(sites, dtype):
    """{pts, tri_v, tri_n, packed, start, q, leaf, ok} of the port's seed
    of ``sites``, captured from ``_seed_state_2d`` (also where its walk
    fails)."""
    seen = {}
    pack, walk = dd._pack_walk_rows, dd._locate_walk_exact

    def pack_spy(pts, tri_v, tri_n):
        seen.update(pts=pts, tri_v=tri_v, tri_n=tri_n)
        return pack(pts, tri_v, tri_n)

    def walk_spy(packed, start, q, **kw):
        leaf, ok = walk(packed, start, q, **kw)
        seen.update(packed=packed, start=start, q=q, leaf=leaf, ok=ok)
        return leaf, ok

    *_, cage, std = dd.build_inputs(sites, flags=host_tree.NOSTANDARDIZE, dtype=dtype)
    dd._pack_walk_rows, dd._locate_walk_exact = pack_spy, walk_spy
    try:
        dd._seed_state_2d(std, cage)
    except dd.SeedLocateError as err:
        print(f"the port's seed: {err}", flush=True)
    finally:
        dd._pack_walk_rows, dd._locate_walk_exact = pack, walk
    return seen


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f64")
    args = ap.parse_args()
    dtype = {"f32": torch.float32, "f64": torch.float64}[args.dtype]
    sites = np.random.default_rng(args.seed).uniform(-0.5, 0.5, (args.sites, 2))

    t0 = time.perf_counter()
    seen = port_seed_walk(sites, dtype)
    port_s = time.perf_counter() - t0
    n_seed = args.sites // dd.SEED_FRAC
    # Sites of the seed that Qhull kept are inserted; every other site is
    # still to insert and must be located.  The walk's start of an
    # inserted site is irrelevant to the build, so both counts below are
    # over the sites still to insert, as _seed_state_2d counts them.
    tv = seen["tri_v"].numpy()
    kept = np.zeros(args.sites, bool)
    kept[np.unique(tv[tv >= 3]) - 3] = True
    todo = ~(kept & (np.arange(args.sites) < n_seed))
    leaf, ok = seen["leaf"].numpy(), seen["ok"].numpy()

    t0 = time.perf_counter()
    jpts = jnp.asarray(seen["pts"].numpy())
    jpacked = jax.jit(jdd._pack_walk_rows)(
        jpts, jnp.asarray(seen["tri_v"].numpy()), jnp.asarray(seen["tri_n"].numpy())
    )
    jwalk = jax.jit(jdd._locate_walk_exact,
                    static_argnames=("max_steps", "lockstep", "tail_div"))
    jleaf, jok = jwalk(jpacked, jnp.asarray(seen["start"].numpy()),
                       jnp.asarray(seen["q"].numpy()))
    jleaf, jok = np.asarray(jleaf), np.asarray(jok)
    jax_s = time.perf_counter() - t0

    bad = np.nonzero(~ok & todo)[0]
    jbad = np.nonzero(~jok & todo)[0]
    rec = {
        "sites": args.sites, "seed": args.seed, "dtype": args.dtype,
        "seed_sites": n_seed, "seed_triangles": int(tv.shape[0]),
        "to_locate": int(todo.sum()),
        "packed_rows_equal": bool(np.array_equal(np.asarray(jpacked), seen["packed"].numpy())),
        "port_unlocated": int(bad.size), "jax_unlocated": int(jbad.size),
        "same_unlocated_sites": bool(np.array_equal(bad, jbad)),
        "leaves_equal": bool(np.array_equal(leaf, jleaf)),
        "ok_equal": bool(np.array_equal(ok, jok)),
        "leaf_mismatches": int((leaf != jleaf).sum()),
        "port_s": port_s, "jax_s": jax_s,
    }
    if bad.size:
        # Which limit left them unlocated: the tail workspace or the steps.
        packed, start, q = seen["packed"], seen["start"], seen["q"]
        for name, kw in (("tail_div_1", dict(tail_div=1)),
                         ("max_steps_4096", dict(max_steps=4096))):
            _, ok2 = dd._locate_walk_exact(packed, start, q, **kw)
            rec[f"unlocated_with_{name}"] = int((~ok2.numpy() & todo).sum())
        # The tail after the lockstep steps, against its workspace.
        B = q.shape[0]
        cur = start.to(torch.int32)
        prev = torch.full((B,), -1, dtype=torch.int32)
        done = torch.zeros(B, dtype=torch.bool)
        for step in range(8):
            cur, prev, done = dd._walk_step(packed, q, cur, prev, done, step)
        rec["tail_after_lockstep"] = int((~done).sum())
        rec["tail_workspace"] = min(B, max(B // 16, 256))
        rec["unlocated_site_ids"] = bad[:50].tolist()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
