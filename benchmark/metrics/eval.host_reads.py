"""eval.host_reads: the program's blocking reads of device values per
request: counters ``device_tri.locate.host_reads`` (the walk's test of
``done``, every ``WALK_DONE_EVERY`` steps) and
``device_tri.locate_cells_host_reads`` (``locate_cells``'s ``nonzero``)."""


def read(run):
    c = run["counters"]
    if "eval.host_reads.walk" not in c or not run["requests"]:
        return None
    return (c["eval.host_reads.walk"] + c["eval.host_reads.select"]) / run["requests"]
