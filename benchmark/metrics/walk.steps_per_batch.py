"""walk.steps_per_batch: lockstep walk steps (counter
``device_tri.locate.steps``) per request."""


def read(run):
    n = run["counters"].get("walk.steps")
    return n / run["requests"] if n is not None and run["requests"] else None
