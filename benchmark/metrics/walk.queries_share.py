"""walk.queries_share: queries the walk fallback took (counter
``device_tri.locate.queries``) over the queries answered, in %."""


def read(run):
    n = run["counters"].get("walk.queries")
    return 100.0 * n / run["queries"] if n is not None and run["queries"] else None
