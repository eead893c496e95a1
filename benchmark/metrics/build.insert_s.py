"""build.insert_s: host seconds of the chunked 2D build's insertion rounds
(split and flip rounds on compacted rows), on the program's own clock:
``ScatteredInterp.build_stats["insert_s"]``, which ends on a host read."""


def read(run):
    return (run.get("build_phases") or {}).get("insert_s")
