"""locate2d.device_ms: profiler device time of the locate library's kernels
(``locate2d_kernel``, ``locate2d_merge``) per 10^6 queries of the traced card."""

# Its kernels are named (anonymous namespace)::locate2d_kernel(...) and
# ...::locate2d_merge(...).
KERNEL_NAME = "::locate2d_"


def read(run):
    t = run["trace"]
    if not t or not run["traced_queries"]:
        return None
    s = sum(v for k, v in t["kernel_s"].items() if KERNEL_NAME in k)
    return 1e3 * s / (run["traced_queries"] / 1e6) if s > 0 else None
