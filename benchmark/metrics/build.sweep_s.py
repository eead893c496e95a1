"""build.sweep_s: host seconds of the chunked 2D build's final flip sweep,
on the program's own clock: ``ScatteredInterp.build_stats["sweep_s"]``,
which ends on a host read."""


def read(run):
    return (run.get("build_phases") or {}).get("sweep_s")
