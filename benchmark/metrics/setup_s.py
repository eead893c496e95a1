"""setup_s: process start to the first timed request (host clock): imports,
kernel load or build, inputs, the build, the cell index and the warm-up."""


def read(run):
    return run["setup_s"]
