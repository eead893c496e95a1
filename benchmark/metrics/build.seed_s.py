"""build.seed_s: host seconds of the chunked 2D build's Qhull seed (scipy's
Delaunay of the first sites, the device walk that locates the rest, the
seed state), on the program's own clock: ``ScatteredInterp.build_stats``
``["seed_s"]``, which ends on a synchronise."""


def read(run):
    return (run.get("build_phases") or {}).get("seed_s")
