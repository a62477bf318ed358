"""Service layer: the synchronous facade over the region serving pipeline.

Port of `repro/region/service.py`. `RegionAllocator` keeps the blocking
API — `submit` requests, `flush`/`solve` return `{cell_id: CellResponse}`
— as a thin facade over the four-layer `RegionPipeline`
(`region.pipeline`):

    admission  — per-bucket request queues + batch-closing policies
                 (`region.admission`: close-on-full / max-wait /
                 deadline-slack, per-request deadlines and priorities);
    planning   — the bucket/chunk planner (`region.planning`): pad mixed
                 pools onto the power-of-two bucket menu on the host,
                 warm-start from the LRU `WarmStartCache`, fill short
                 chunks with all-inactive pad cells that converge in one
                 masked iteration, move the batch to the device once;
    dispatch   — `solve()` on the batch (`region.dispatch`), results kept
                 on the device behind a CUDA event, up to `pipeline_depth`
                 batches unmaterialized;
    completion — one packed device->host copy per batch
                 (`region.completion`), resolving `PendingResponse`
                 futures and writing the warm cache.

Same bucket-ascending/arrival-order grouping, same warm-start decisions
(in-flight cells stall planning until their solutions land in the cache)
and same responses as the reference's facade at any `pipeline_depth`.

Per-stage wall time (queue wait / plan / dispatch / device / gather) is
tracked in `RegionAllocator.clocks`; `stats` keeps the request/batch/
cache/shape counters — the acceptance signals for bucketing and warm
starts. For latency-shaped serving drive the `RegionPipeline` directly:
`submit()` returns futures and `poll()` runs the batch-closing policy.

Not ported: the reference's legacy solver keywords (`max_iters`, `tol`,
`sp*_method`, `sp2_iters`; pass a `SolverSpec`) and its `solver_kw` and
`_cache` views.
"""
from __future__ import annotations

from typing import Dict, Hashable, Optional, Sequence

from ..api import SolverSpec
from ..core.accuracy import AccuracyModel
from ..core.types import Weights
from .admission import AllocationRequest, BatchPolicy, StageClocks
from .batch import DEFAULT_MIN_BUCKET
from .completion import CellResponse, PendingResponse
from .pipeline import RegionPipeline

__all__ = ["AllocationRequest", "CellResponse", "RegionAllocator"]


class RegionAllocator:
    """Streaming allocation front-end: submit requests, flush batches.

    Parameters
    ----------
    w : the region's *default* objective weights; any request may override
        them with its own `AllocationRequest.w`.
    spec : a `SolverSpec` with the solver options every batch uses.
    mesh : a `RegionMesh` to split batches over (None = one fleet batch
        on `device`); see `region_mesh`.
    cells_per_batch : fixed cell-axis length of every batch.
    min_bucket : floor of the power-of-two device-count buckets.
    cache_size : max cells kept in the warm-start LRU.
    policy : admission batch-closing policy for the async path (default
        close-on-full; `flush`/`solve` force-close regardless).
    pipeline_depth : max dispatched-but-unmaterialized batches (1 = the
        serial solve-then-gather loop; 2 = double buffering).
    device : where batches are solved (CUDA by default, or "cpu").
    """

    def __init__(self, w: Weights, acc: Optional[AccuracyModel] = None,
                 mesh=None, cells_per_batch: int = 32,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 cache_size: int = 4096,
                 spec: Optional[SolverSpec] = None,
                 policy: Optional[BatchPolicy] = None,
                 pipeline_depth: int = 2, device=None):
        if cells_per_batch < 1:
            raise ValueError("cells_per_batch must be >= 1")
        self.spec = spec if spec is not None else SolverSpec()
        self.w = w
        self.acc = acc
        self.mesh = mesh
        self.cells_per_batch = int(cells_per_batch)
        self.min_bucket = int(min_bucket)
        self.cache_size = int(cache_size)
        self.pipeline = RegionPipeline(
            w, acc=acc, mesh=mesh, cells_per_batch=cells_per_batch,
            min_bucket=min_bucket, cache_size=cache_size, spec=self.spec,
            policy=policy, max_in_flight=pipeline_depth, device=device)

    # ------------------------------------------------------------- stream
    def submit(self, request: AllocationRequest) -> PendingResponse:
        """Queue a request for the next `flush()`. The returned future can
        also be resolved directly (`.result()` force-drives the pipeline)."""
        return self.pipeline.submit(request)

    def flush(self) -> Dict[Hashable, CellResponse]:
        """Solve everything queued since the last flush."""
        return {r.cell_id: r for r in self.pipeline.drain()}

    # -------------------------------------------------------------- batch
    def solve(self, requests: Sequence[AllocationRequest]
              ) -> Dict[Hashable, CellResponse]:
        """Coalesce `requests` into bucketed batches and solve them all.

        Requests are grouped by device-count bucket; each group is chunked
        into fixed `cells_per_batch` solves. Returns {cell_id:
        CellResponse}.
        """
        for r in requests:
            self.pipeline.submit(r)
        return {r.cell_id: r for r in self.pipeline.drain()}

    def invalidate(self, cell_id: Hashable) -> bool:
        """Drop a cell's warm-start cache entry (mobility handover: the
        member set changed, so its cached solution no longer maps to the
        pool). The next request for the cell cold-starts; the purge is
        counted in `stats["handover_purges"]`."""
        return self.pipeline.invalidate(cell_id)

    # -------------------------------------------------------------- stats
    @property
    def stats(self) -> dict:
        """Serving tallies: request/batch/cache counts plus the solver and
        deadline aggregates (`cells_solved`, `cells_converged`,
        `deadline_hits`/`deadline_requests`, and `solver_counters` — summed
        bcd_iters/sp1_evals/sp2_evals across every materialized batch)."""
        return self.pipeline.stats

    @property
    def clocks(self) -> StageClocks:
        """Per-stage wall clocks (queue wait / plan / dispatch / device /
        gather) aggregated across the pipeline."""
        return self.pipeline.clocks

    @property
    def compiled_shapes(self) -> set:
        """Distinct (cells, devices) batch shapes solved so far (the
        bucketing acceptance metric)."""
        return self.pipeline.compiled_shapes
