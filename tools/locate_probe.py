"""Price the order and the min and max instructions of the locate
kernel's sweep on one CUDA card.

Builds copies of ``kernels/csrc/locate2d.cu`` with the repo's nvcc flags:
the running max, the two mins of the score, or all three turned into float
adds (wrong leaves: they time the instruction mix); and, as right kernels,
the sweep taken triangle by triangle across the rows instead of row by
row, a row's four scores met in a tree before its running max, the group's
loop unrolled whole, and 4 queries a thread instead of 8.  It times each
at chip_smoke.py's headline (10^6 queries, T = 4,001, the plan's split for
the variant's queries per thread) beside the kernel as it is, and prints
the hot loop's instructions per pair (cuobjdump) and the scheduler cycles
per pair at the card's 1,980 MHz (what ``tools/locate_tune.py --clocks``
reads under this kernel's load).  Only the times mean anything: it does
not check any variant's leaves.  A split launch starts from merge keys
filled with ``locate.INITIAL_KEY``, as the wrapper's do.  Its edits match
the sweep's source text, so they change with it:

    PYTHONPATH=. python3 tools/locate_probe.py

Its libraries go to the kernels' gitignored build directory.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke
from gsl_scattered_interpolation_torch.kernels import build
from gsl_scattered_interpolation_torch.ops import locate

MAX = ("gm[r] = fmaxf(gm[r], pair_score(", "gm[r] = __fadd_rn(gm[r], pair_score(")
MINS = ("return fminf(fminf(c0, c1), __fsub_rn(__fsub_rn(1.0f, c0), c1));",
        "return __fadd_rn(__fadd_rn(c0, c1), __fsub_rn(__fsub_rn(1.0f, c0), c1));")
ROW_LOOPS = """#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            gm[r] = fmaxf(gm[r], pair_score(qx[r], qy[r], lane(v0, j), lane(v1, j),
                                            lane(v2, j), lane(v3, j), lane(v4, j),
                                            lane(v5, j)));
          }
        }"""
# The kernel's first order: triangle by triangle, each across the rows.
BY_TRIANGLE = (ROW_LOOPS, """#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            gm[r] = fmaxf(gm[r], pair_score(qx[r], qy[r], lane(v0, j), lane(v1, j),
                                            lane(v2, j), lane(v3, j), lane(v4, j),
                                            lane(v5, j)));
          }
        }""")
# A row's four scores meet in a tree before the running max.
TREE = (ROW_LOOPS, """#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float s[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[j] = pair_score(qx[r], qy[r], lane(v0, j), lane(v1, j), lane(v2, j),
                              lane(v3, j), lane(v4, j), lane(v5, j));
          }
          gm[r] = fmaxf(gm[r], fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3])));
        }""")
UNROLL = ("#pragma unroll 2\n      for (int k = grp / 4;", "#pragma unroll\n      for (int k = grp / 4;")
ROWS_4 = ("constexpr int kRows = 8;", "constexpr int kRows = 4;")
# name: (edits, queries per thread)
VARIANTS = {"as_is": ((), 8), "max_as_add": ((MAX,), 8), "mins_as_adds": ((MINS,), 8),
            "all_as_adds": ((MAX, MINS), 8), "by_triangle": ((BY_TRIANGLE,), 8),
            "tree_of_four": ((TREE,), 8), "group_unrolled": ((UNROLL,), 8),
            "rows_4": ((ROWS_4,), 4)}


def variant_library(name, edits):
    src = (build.CSRC / "locate2d.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / f"probe_{name}.cu"
    lib = build.BUILD_DIR / f"libprobe_{name}.so"
    cu.write_text(src)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                   capture_output=True, text=True, timeout=build.NVCC_TIMEOUT_S, check=True)
    return lib


def sass_per_pair(lib):
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    listing = chip_smoke.parse_sass(sass)
    fn = next(f for f in listing if "locate2d_kernel" in f)
    return chip_smoke.sass_inner_loop(listing[fn])


def main() -> int:
    if not torch.cuda.is_available():
        print("locate_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    tri = chip_smoke.host_triangulation(chip_smoke.N_SITES, 0, "cuda")
    q = chip_smoke.uniform_queries(chip_smoke.BATCH, seed=2, device="cuda")[0]
    centre, g, b = locate.pack_tables(tri)
    B, T = q.shape[0], tri.n_tris
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    keys = torch.empty(B, dtype=torch.int64, device="cuda")
    leaf = torch.empty(B, dtype=torch.int32, device="cuda")
    source_rows = locate.ROWS
    for name, (edits, rows) in VARIANTS.items():
        locate.ROWS = rows  # plan() for the variant's queries per thread
        locate.plan.cache_clear()
        slices, length = locate.plan(B, T, n_sms)
        lib = variant_library(name, edits)
        fn = ctypes.CDLL(str(lib)).locate2d_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int

        def launch():
            if slices > 1:
                keys.fill_(locate.INITIAL_KEY)
            err = fn(q.data_ptr(), centre.data_ptr(), g.data_ptr(), b.data_ptr(), None, B, T,
                     slices, length, keys.data_ptr(), leaf.data_ptr(), None,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{name}: CUDA error {err}")

        loop = sass_per_pair(lib)
        ms = chip_smoke.kernel_ms(launch, 10)
        print(json.dumps({
            "variant": name, "B": B, "T": T, "rows": rows, "slices": slices,
            "device_ms": ms,
            "sass_per_pair": loop["per_pair"],
            "sass_per_pair_by_op": loop["per_pair_by_op"],
            "cycles_per_pair_at_1980": ms * 1e-3 * 1.98e9 * n_sms * 4 * 32 / (B * T)}))
    locate.ROWS = source_rows
    locate.plan.cache_clear()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
