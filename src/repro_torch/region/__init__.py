"""repro_torch.region — the region serving stack of `repro.region`.

  * mesh   (`region.mesh`): split the cell axis of a stacked fleet over a
    `RegionMesh` — set `Problem.mesh` (built with `region_mesh`) and
    `solve` runs each shard's cell block with its own convergence exit
    (`SolverSpec.lockstep=True`: one batch, every shard the global
    iteration count);
  * batch  (`region.batch`): pad mixed-size cell pools onto a power-of-two
    bucket menu with masked devices (`pad_system`, `bucket_size`);
    `inactive_system` builds the all-masked filler cells short chunks pad
    with;
  * the serving pipeline (`region.pipeline`): **admission**
    (`region.admission`: per-bucket queues, deadlines, priorities,
    pluggable batch-closing policies), **planning** (`region.planning`:
    the bucket/chunk planner, host-side assembly, warm-start LRU),
    **dispatch** (`region.dispatch`: `solve()` on the batch, a CUDA event
    behind it), and **completion** (`region.completion`: one packed host
    copy per batch resolving `PendingResponse` futures) — with per-stage
    `StageClocks`;
  * service (`region.service`): `RegionAllocator`, the synchronous facade
    over the pipeline (submit/flush/solve). Requests take per-request
    `Weights`.

Not ported: the deprecated `allocate_region` / `run_rounds_region` shims
and the reference's legacy `RegionAllocator` solver keywords.
"""
from .admission import (AdmissionQueue, AllocationRequest, BatchPolicy,
                        CloseOnFull, DeadlineSlack, MaxWait, StageClocks)
from .batch import bucket_size, inactive_system, pad_allocation, pad_system
from .completion import CellResponse, PendingResponse
from .mesh import (RegionMesh, RegionResult, cell_specs, pad_cells,
                   region_mesh)
from .pipeline import RegionPipeline
from .planning import BatchPlan, BatchPlanner, WarmStartCache, group_requests
from .service import RegionAllocator

__all__ = [
    "bucket_size", "inactive_system", "pad_allocation", "pad_system",
    "RegionMesh", "RegionResult", "cell_specs", "pad_cells", "region_mesh",
    "AdmissionQueue", "AllocationRequest", "BatchPolicy", "CloseOnFull",
    "DeadlineSlack", "MaxWait", "StageClocks",
    "BatchPlan", "BatchPlanner", "WarmStartCache", "group_requests",
    "CellResponse", "PendingResponse", "RegionPipeline", "RegionAllocator",
]
