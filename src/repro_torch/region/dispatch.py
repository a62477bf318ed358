"""Dispatch layer: launch a planned batch and return it *in flight*.

Port of `repro/region/dispatch.py`. `Dispatcher.dispatch` runs the
planned batch through `repro_torch.solve` and records a `torch.cuda.Event`
on the current stream right after it; the `InFlightBatch` holds the
result tensors and that event (None on a CPU pipeline). The completion
layer waits on the event and copies the results to the host later, once
per batch, so the pipeline can plan batch k+1 before batch k is gathered,
with `RegionPipeline.max_in_flight` bounding the queue depth.

Unlike JAX's dispatch, a torch solve is not asynchronous end to end: the
port's BCD reads "is any cell still running" back to the host once per
loop iteration (`core/loops.py::while_cells`), so `solve` returns only
after the last iteration's exit test, and "in flight" covers only the
tail of work still queued on the card behind that last read. The
"dispatch" stage clock therefore holds most of a batch's solve time and
the "device" stage the tail.

Host time spent in `solve` is charged to the "dispatch" stage of
`StageClocks`; the in-flight window is observed by the completion layer
("device").
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional

import torch

from ..api import Problem, SolverSpec, solve
from ..core.accuracy import AccuracyModel, default_accuracy
from ..core.bcd import FleetResult
from .admission import StageClocks
from .planning import BatchPlan


@dataclasses.dataclass
class InFlightBatch:
    """A dispatched batch whose results are not yet on the host.

    `result` holds the solve's tensors on the device; `event` is the CUDA
    event recorded after the solve (None on the CPU); `pending` holds the
    `PendingResponse` futures bound to the plan's real lanes (aligned by
    index). `seq` is the dispatch order — the completion order the
    synchronous facade reproduces."""
    plan: BatchPlan
    result: FleetResult
    t_dispatched: float
    seq: int
    event: Optional[torch.cuda.Event] = None
    pending: List[Any] = dataclasses.field(default_factory=list)
    materialized: bool = False


class Dispatcher:
    """Run planned batches through the one `solve()` entry point.

    Per-request weights ride along as the (C, 3) weights tensor of the
    solve. `mesh=None` solves on the plan's device as one fleet batch; a
    `RegionMesh` splits the cell axis (`region_mesh`, shard-local exits
    unless `spec.lockstep`).
    """

    def __init__(self, spec: SolverSpec,
                 acc: Optional[AccuracyModel] = None, mesh=None,
                 clocks: Optional[StageClocks] = None):
        self.spec = spec
        self.acc = acc if acc is not None else default_accuracy()
        self.mesh = mesh
        self.clocks = clocks if clocks is not None else StageClocks()
        self._seq = 0

    def dispatch(self, plan: BatchPlan) -> InFlightBatch:
        """Solve one batch; returns without copying results to the host."""
        t0 = time.monotonic()
        res = solve(Problem(system=plan.sys_batch, weights=plan.weights,
                            acc=self.acc, init=plan.init_batch,
                            mesh=self.mesh), self.spec)
        fleet = res.fleet if hasattr(res, "fleet") else res
        event = None
        if fleet.objective.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(fleet.objective.device))
        t1 = time.monotonic()
        self.clocks.record("dispatch", t1 - t0)
        batch = InFlightBatch(plan=plan, result=fleet, t_dispatched=t1,
                              seq=self._seq, event=event)
        self._seq += 1
        return batch
