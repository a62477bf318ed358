"""The pipelined region serving stack: admission -> planning -> dispatch ->
completion.

Port of `repro/region/pipeline.py`: the same layers, depth bound,
ordering and warm-start coherence. Batches are assembled on the host and
solved on the pipeline's `device` (CUDA unless the caller names "cpu").

`RegionPipeline` wires the four layers around one shared `StageClocks` and
one `WarmStartCache`:

  * **admission** (`region.admission`): `submit()` files the request under
    its device-count bucket and returns a `PendingResponse` future; a
    pluggable `BatchPolicy` (close-on-full, max-wait, deadline-slack)
    decides when a bucket's queue closes into a batch.
  * **planning** (`region.planning`): closed batches are padded/stacked
    into fixed-shape `BatchPlan`s, warm-started from the LRU cache.
  * **dispatch** (`region.dispatch`): plans run through the one `solve()`
    entry point; results stay on the device in an `InFlightBatch` with a
    CUDA event. Up to `max_in_flight` batches may be unmaterialized at
    once (two by default), so batch k+1 is planned before batch k is
    gathered. The port's solve reads the host once per BCD iteration, so
    only the tail of a batch's work is still running when the next one is
    planned (see `region.dispatch`).
  * **completion** (`region.completion`): one blocking gather per batch,
    on demand — `PendingResponse.result()`, an explicit `drain()`, or the
    depth bound materializing the oldest batch before a new one is
    planned.

Warm-start coherence: a batch whose results are not yet materialized has
not written the cache, so planning a re-request of an *in-flight* cell
would silently cold-start it (and desync from the synchronous semantics).
The pipeline tracks in-flight cell ids (`_dirty`) and materializes
in-flight batches, oldest first, until the conflict clears — traces where
a cell is requested at most once per batch window (the normal shape) never
stall.

The synchronous `RegionAllocator` (`region.service`) is a thin facade over
this class; `pump()`/`poll()` + `PendingResponse` are the asynchronous
surface for callers that own their event loop.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, Hashable, List, Optional

import torch

from .. import obs
from ..api import SolverSpec
from ..core.accuracy import AccuracyModel
from ..core.types import Weights, resolve_device
from .admission import (AdmissionQueue, AllocationRequest, BatchPolicy,
                        StageClocks)
from .batch import DEFAULT_MIN_BUCKET
from .completion import CellResponse, PendingResponse, materialize
from .dispatch import Dispatcher, InFlightBatch
from .planning import BatchPlanner, WarmStartCache


class RegionPipeline:
    """Asynchronous four-layer serving pipeline for region allocation.

    Parameters mirror `RegionAllocator` plus:

    policy : the admission batch-closing policy (default `CloseOnFull`).
    max_in_flight : how many dispatched batches may be unmaterialized at
        once (>= 1). 1 is the serial solve-then-gather loop; 2 (default)
        plans batch k+1 before gathering batch k.
    device : where batches are solved (CUDA by default; "cpu" on a machine
        without one — there is no silent fallback).
    """

    def __init__(self, w: Weights, acc: Optional[AccuracyModel] = None,
                 mesh=None, cells_per_batch: int = 32,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 cache_size: int = 4096,
                 spec: Optional[SolverSpec] = None,
                 policy: Optional[BatchPolicy] = None,
                 max_in_flight: int = 2, device=None):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        self.w = w
        self.spec = spec if spec is not None else SolverSpec()
        self.cells_per_batch = int(cells_per_batch)
        self.min_bucket = int(min_bucket)
        self.max_in_flight = int(max_in_flight)
        self.device: torch.device = resolve_device(device)
        self.clocks = StageClocks()
        self.cache = WarmStartCache(cache_size)
        self.admission = AdmissionQueue(cells_per_batch, min_bucket,
                                        policy, clocks=self.clocks)
        self.planner = BatchPlanner(w, self.cache, cells_per_batch,
                                    min_bucket, clocks=self.clocks,
                                    device=self.device)
        self.dispatcher = Dispatcher(self.spec, acc, mesh,
                                     clocks=self.clocks)
        self._in_flight: Deque[InFlightBatch] = deque()
        self._dirty: Dict[Hashable, int] = {}   # in-flight cell -> count
        self._unclaimed: List[PendingResponse] = []
        self.stats = dict(requests=0, batches=0, cache_hits=0,
                          cache_misses=0, cells_padded=0,
                          handover_purges=0, shapes=set(),
                          cells_solved=0, cells_converged=0,
                          deadline_hits=0, deadline_requests=0,
                          solver_counters={})

    # ------------------------------------------------------------ streaming
    def submit(self, request: AllocationRequest,
               now: Optional[float] = None) -> PendingResponse:
        """Admit one request; returns its future. Nothing is dispatched
        until `pump()`/`poll()` closes a batch (or `result()` forces it)."""
        now = time.monotonic() if now is None else now
        pending = PendingResponse(request, self)
        pending.t_enqueue = now   # end-to-end latency origin (obs events)
        self.admission.submit(request, now, token=pending)
        self._unclaimed.append(pending)
        self.stats["requests"] += 1
        return pending

    def poll(self, now: Optional[float] = None) -> List[InFlightBatch]:
        """Policy-driven pump: close and dispatch whatever the batch policy
        says is ready at `now`. Call this from the serving event loop."""
        return self.pump(now=now, force=False)

    def pump(self, now: Optional[float] = None,
             force: bool = False) -> List[InFlightBatch]:
        """Close ready batches (all of them when `force`), plan and
        dispatch each — materializing oldest in-flight batches first
        whenever dispatching would exceed `max_in_flight`. Returns the
        batches dispatched by this call."""
        dispatched: List[InFlightBatch] = []
        for bucket, entries in self.admission.close_ready(now, force):
            # warm-start coherence: a cell still in flight has not written
            # its solution to the cache yet — drain oldest-first until the
            # conflict clears (no-op for traces without in-window repeats)
            while self._in_flight and any(
                    e.request.cell_id in self._dirty for e in entries):
                self._materialize(self._in_flight[0])
            # depth bound BEFORE planning: at max_in_flight=1 this batch's
            # assembly starts only after the previous gather (the serial
            # solve-then-gather loop); at >= 2 the previous batch may
            # still be finishing on the card underneath it
            while len(self._in_flight) >= self.max_in_flight:
                self._materialize(self._in_flight[0])
            with obs.span("plan", bucket=bucket, n_real=len(entries)):
                plan = self.planner.plan([e.request for e in entries],
                                         bucket)
            with obs.span("dispatch", bucket=bucket):
                batch = self.dispatcher.dispatch(plan)
            for lane, e in enumerate(entries):
                e.token._bind(batch, lane)
            for r in plan.requests:
                self._dirty[r.cell_id] = self._dirty.get(r.cell_id, 0) + 1
            self.stats["batches"] += 1
            self.stats["shapes"].add((self.cells_per_batch, plan.bucket))
            self.stats["cells_padded"] += self.cells_per_batch - plan.n_real
            self.stats["cache_hits"] += sum(plan.warm)
            self.stats["cache_misses"] += plan.n_real - sum(plan.warm)
            self._in_flight.append(batch)
            dispatched.append(batch)
        return dispatched

    def invalidate(self, cell_id: Hashable) -> bool:
        """Handover invalidation: drop `cell_id`'s warm-start entry (its
        member set changed under mobility, so the cached solution maps to
        the wrong devices — a same-size pool would otherwise warm-hit with
        a stale mapping). A batch still in flight for the cell is
        materialized first so its store cannot resurrect the stale entry.
        Returns whether an entry was dropped; `stats["handover_purges"]`
        mirrors the cache counter."""
        while self._in_flight and cell_id in self._dirty:
            self._materialize(self._in_flight[0])
        purged = self.cache.purge(cell_id)
        self.stats["handover_purges"] = self.cache.handover_purges
        return purged

    def drain(self, now: Optional[float] = None) -> List[CellResponse]:
        """Force-close everything queued, materialize everything in flight,
        and claim all outstanding futures. Responses come back in
        (dispatch order, lane order) — the completion order of a
        synchronous solve loop."""
        self.pump(now=now, force=True)
        while self._in_flight:
            self._materialize(self._in_flight[0])
        claimed, self._unclaimed = self._unclaimed, []
        claimed.sort(key=lambda p: (p._batch.seq, p._lane))
        return [p.result() for p in claimed]

    # ------------------------------------------------------------ internals
    def _materialize(self, batch: InFlightBatch) -> None:
        with obs.span("materialize", batch_seq=batch.seq):
            materialize(batch, self.cache, self.clocks, self.stats)
        try:
            self._in_flight.remove(batch)
        except ValueError:
            pass   # already removed by an out-of-order result()
        for r in batch.plan.requests:
            left = self._dirty.get(r.cell_id, 0) - 1
            if left <= 0:
                self._dirty.pop(r.cell_id, None)
            else:
                self._dirty[r.cell_id] = left

    def _force(self, pending: PendingResponse) -> None:
        """Drive one future to completion: dispatch its batch if still
        queued, then materialize only that batch (out-of-order OK)."""
        if pending._batch is None:
            self.pump(force=True)
        if pending._batch is None:   # pragma: no cover - defensive
            raise RuntimeError(
                "PendingResponse: request never left the admission queue")
        if not pending._batch.materialized:
            self._materialize(pending._batch)

    # ------------------------------------------------------------ accounting
    @property
    def pending(self) -> int:
        """Requests admitted but not yet dispatched."""
        return self.admission.pending

    @property
    def in_flight(self) -> int:
        """Dispatched batches not yet materialized."""
        return len(self._in_flight)

    @property
    def compiled_shapes(self) -> set:
        """Distinct (cells, devices) batch shapes dispatched so far (the
        bucketing acceptance metric; the reference compiles one program for
        each)."""
        return set(self.stats["shapes"])
