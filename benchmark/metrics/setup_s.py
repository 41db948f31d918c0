"""Seconds from the process's start to the first timed step: imports, the
kernels' load (and build, on a checkout's first run), the weights, the
data and the first steps."""


def read(run):
    return run.setup_s
