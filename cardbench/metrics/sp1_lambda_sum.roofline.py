"""sp1_lambda_sum.roofline (%): the SP1 dual sweep's bound time over its
device time in the traced call. The bound is the larger of the sweep's
operations at 67 TFLOP/s (float32 outside the tensor cores) and its bytes
at 3.35 TB/s, counted from each call's inputs (`harness/roofline.py`), so
it reads the same work whatever implements the sweep; the device time is
that of the kernels named `::sp1_` in the trace. Stated against one H100
SXM's published peaks at 700 W: a card set to a lower power limit reads
lower. Layer: kernels/sp1_sweep. Moves alloc_s. Nothing to read where the
traced call ran no sweep kernel (the deadline mix)."""
from harness import roofline


def read(run):
    if run.trace is None or not run.sp1_work:
        return None
    device_s = sum(s for name, (_, s) in run.trace["kernels"].items()
                   if "::sp1_" in name)
    if device_s <= 0:
        return None
    bound = sum(roofline.bound_s(ops, moved, run.dtype)
                for ops, moved in run.sp1_work)
    return 100.0 * bound / device_s
