"""idle_share (%): the share of the traced call's window in which no
operation ran on the card, from the union of the device events' intervals
in the profiler's raw kineto events. Layer: device. Moves alloc_s: how far
the host holds the card back."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
