"""cells.device_ms: profiler device time of the operations launched in the
program's span ``device_tri.locate_cells.score`` (the cell index's row
gather, scoring, argmax and the walk mask) per 10^6 queries of the traced
card."""


def read(run):
    v = (run.get("program_spans") or {}).get("device_tri.locate_cells.score")
    if v is None or v["device_s"] <= 0 or not run["traced_queries"]:
        return None
    return 1e3 * v["device_s"] / (run["traced_queries"] / 1e6)
