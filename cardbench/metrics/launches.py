"""launches (kernels): the device kernels of the traced call (memory
copies and sets left out), over the allocations it completed. Layer:
device. Moves alloc_s: the host pays a launch's overhead for each."""


def read(run):
    if run.trace is None or not run.trace["launches"]:
        return None
    return run.trace["launches"] / run.traced_allocations
