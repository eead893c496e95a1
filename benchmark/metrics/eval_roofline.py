"""eval_roofline: the least time any implementation needs for the traced
card's queries (peaks.eval_floor_s: 12 bytes and 25 operations a query)
over the device's busy time in the traced window, in %."""

from benchmark import peaks


def read(run):
    t = run["trace"]
    if not t or t["busy_s"] <= 0 or not run["traced_queries"]:
        return None
    return 100.0 * peaks.eval_floor_s(run["traced_queries"]) / t["busy_s"]
