"""setup_s (s), end to end: process start to the measured window: the
imports, the build of the port's kernels (a checkout's first run only),
the pool's draws on the card and one warm call."""


def read(run):
    return run.setup_s
