"""build_s: the set-up's ``ScatteredInterp`` build, host clock, synchronised."""


def read(run):
    return run["build_s"]
