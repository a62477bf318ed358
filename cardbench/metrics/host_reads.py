"""host_reads (reads): the host reads of the port's per-cell while loops
(`core/loops.py::while_cells.host_reads`) in the window, over its
allocations. Layer: core/loops.py. Moves alloc_s: each read waits for the
card to drain its queue."""


def read(run):
    return run.host_reads / run.allocations if run.allocations else None
