"""alloc_s (s), end to end: the measured window's seconds over the
allocations it completed (a closed loop of one caller, each allocation
sent when the last is back): the time an operator waits for a region's
allocation."""


def read(run):
    return run.window_s / run.allocations if run.allocations else None
