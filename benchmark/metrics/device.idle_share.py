"""device.idle_share: share of the traced window in which no operation ran
on the (rank 0's) card: 1 - union of device intervals / window, in %."""


def read(run):
    t = run["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
