"""Completion layer: materialize in-flight batches into `CellResponse`s.

Port of `repro/region/completion.py`. The device->host transfer of the
pipeline happens here, once per batch: wait on the batch's CUDA event,
copy every result field of the whole batch to the host in ONE packed copy
(allocations, T, objective, iterations, convergence and the solver
counters, side by side in one (C, 5N + 8) tensor), slice every real lane
back to its unpadded (N,) shape on the host, write the solutions into the
warm-start cache, and resolve the batch's `PendingResponse` futures.
Nothing is sliced on the device: a small op there would cost a launch
per lane.

`PendingResponse` is the caller-facing future: `result()` materializes on
demand (forcing dispatch first if the request is still queued), so callers
can hold responses from several in-flight batches and consume them in any
order — materializing batch k+2 never waits on batch k.

Stage clocks: the in-flight window (dispatch -> the event observed
complete, an upper bound measured at the first blocking wait) is
recorded as a per-batch "device" sample; the host-side copy/slice/cache
write time as a "gather" sample (see `StageClocks`).

Telemetry: with a `repro_torch.obs` recorder enabled, materializing a
batch emits one "request" point per real lane carrying the cell id,
warm/bucket facts, the solve's counters (BCD iterations, SP1/SP2 dual
evals, residual), the end-to-end `latency_s` (submit -> materialize;
wall-clock — meaningful when the admission clock is the default
`time.monotonic`), and — for deadlined requests — `deadline_hit` (same
clock caveat).

The always-on metric plane is fed here too (the SLO plane's inputs): per
batch, `region_solve_cells` / `region_solve_converged_cells` counters,
the `region_request_latency_seconds` histogram, deadline hit/miss/request
counters, and the summed solver-effort counters
(`region_solver_{bcd_iters,sp1_evals,sp2_evals}`); the same sums land in
`RegionPipeline.stats["solver_counters"]` when the pipeline passes its
stats dict in.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Hashable, List, Optional

import torch

from .. import obs
from ..core.types import Allocation
from .admission import AllocationRequest, StageClocks
from .dispatch import InFlightBatch
from .planning import WarmStartCache

Tensor = torch.Tensor


@dataclasses.dataclass
class CellResponse:
    cell_id: Hashable
    allocation: Allocation   # unpadded (N,) host tensors
    objective: float
    iters: int
    converged: bool
    warm: bool               # served from the warm-start cache
    bucket: int              # padded device count this cell solved at


class PendingResponse:
    """A future for one request's `CellResponse`.

    Lifecycle: queued (in admission) -> in flight (bound to a dispatched
    batch) -> done. `result()` drives whatever remains: a queued request
    force-pumps the pipeline, an in-flight one materializes only its own
    batch."""

    def __init__(self, request: AllocationRequest, pipeline):
        self.request = request
        self.cell_id = request.cell_id
        self.t_enqueue: Optional[float] = None   # set at admission
        self._pipeline = pipeline
        self._batch: Optional[InFlightBatch] = None
        self._lane: int = -1
        self._response: Optional[CellResponse] = None

    @property
    def dispatched(self) -> bool:
        return self._batch is not None

    def done(self) -> bool:
        return self._response is not None

    def result(self) -> CellResponse:
        if self._response is None:
            self._pipeline._force(self)
        if self._response is None:   # pragma: no cover - defensive
            raise RuntimeError("PendingResponse: the batch resolved no "
                               "response for this request")
        return self._response

    def _bind(self, batch: InFlightBatch, lane: int) -> None:
        self._batch = batch
        self._lane = lane
        batch.pending.append(self)


def _host_pack(res) -> Tensor:
    """Every field of a fleet result side by side, (C, 5N + 4 + counters),
    in the result's dtype, copied to the host in one transfer. iters and
    converged are small integers, exact in either float type."""
    a = res.allocation
    dt = a.bandwidth.dtype
    s_rel = a.resolution if a.s_relaxed is None else a.s_relaxed
    cols = [a.bandwidth, a.power, a.freq, a.resolution, s_rel,
            a.T.reshape(-1, 1), res.objective.reshape(-1, 1),
            res.iters.to(dt).reshape(-1, 1),
            res.converged.to(dt).reshape(-1, 1)]
    if res.counters is not None:
        cols.append(res.counters.data.to(dt))
    return torch.cat(cols, 1).cpu()


def materialize(batch: InFlightBatch, cache: WarmStartCache,
                clocks: StageClocks,
                stats: Optional[dict] = None) -> List[CellResponse]:
    """Gather one batch host-side and resolve its futures (idempotent).
    `stats`, when given (the pipeline's dict), accumulates solver-effort
    counter sums and deadline/convergence tallies alongside the metric
    registry."""
    if batch.materialized:
        return [p._response for p in batch.pending]
    plan, res = batch.plan, batch.result
    if batch.event is not None:
        batch.event.synchronize()
    t1 = time.monotonic()
    clocks.record("device", max(0.0, t1 - batch.t_dispatched))
    host = _host_pack(res)
    N = res.allocation.bandwidth.shape[1]
    bw, pw, fq, sr, s_rel = (host[:, k * N:(k + 1) * N] for k in range(5))
    T, objs, iters, conv = (host[:, 5 * N + k] for k in range(4))
    ctr = host[:, 5 * N + 4:] if res.counters is not None else None
    keep_s_rel = res.allocation.s_relaxed is not None
    responses: List[CellResponse] = []
    for c, (r, hit) in enumerate(zip(plan.requests, plan.warm)):
        n = r.sys.n
        alloc = Allocation(
            bandwidth=bw[c, :n], power=pw[c, :n],
            freq=fq[c, :n], resolution=sr[c, :n],
            s_relaxed=s_rel[c, :n] if keep_s_rel else None, T=T[c])
        cache.store(r.cell_id, n, alloc)
        responses.append(CellResponse(
            cell_id=r.cell_id, allocation=alloc,
            objective=float(objs[c]), iters=int(iters[c]),
            converged=bool(conv[c]), warm=hit, bucket=plan.bucket))
    ccols = None if ctr is None else res.counters.columns
    t_done = time.monotonic()
    n_real = len(plan.requests)
    _record_metrics(batch, ctr, ccols, conv, n_real, t_done, stats)
    if obs.enabled():
        for pending in batch.pending:
            r = responses[pending._lane]
            fields = dict(cell_id=str(r.cell_id), bucket=r.bucket,
                          warm=r.warm, iters=r.iters,
                          converged=r.converged, batch_seq=batch.seq)
            if ctr is not None:
                fields.update({c: float(v) for c, v in
                               zip(ccols, ctr[pending._lane].tolist())})
            if pending.t_enqueue is not None:
                fields["latency_s"] = max(0.0, t_done - pending.t_enqueue)
            if pending.request.deadline is not None:
                fields["deadline_hit"] = bool(
                    t_done <= pending.request.deadline)
            obs.point("request", **fields)
    for pending in batch.pending:
        pending._response = responses[pending._lane]
    batch.materialized = True
    clocks.record("gather", time.monotonic() - t1)
    return responses


def _record_metrics(batch: InFlightBatch, ctr: Optional[Tensor], ccols,
                    conv: Tensor, n_real: int, t_done: float,
                    stats: Optional[dict]) -> None:
    """Always-on metric-plane accounting for one materialized batch (host
    tensors only): the counters/histograms the SLO plane
    (`obs.slo.default_slos`) evaluates. Deadline hits compare
    `time.monotonic()` against the request deadline — meaningful when the
    admission clock is the default one (the same caveat the `latency_s`
    event field carries)."""
    conv_real = int(conv[:n_real].sum())
    obs.counter("region_solve_cells").inc(n_real)
    obs.counter("region_solve_converged_cells").inc(conv_real)
    lat_h = obs.histogram("region_request_latency_seconds")
    dl_hits = dl_total = 0
    for pending in batch.pending:
        if pending.t_enqueue is not None:
            lat_h.observe(max(0.0, t_done - pending.t_enqueue))
        if pending.request.deadline is not None:
            dl_total += 1
            dl_hits += bool(t_done <= pending.request.deadline)
    if dl_total:
        obs.counter("region_deadline_requests").inc(dl_total)
        obs.counter("region_deadline_hits").inc(dl_hits)
        obs.counter("region_deadline_misses").inc(dl_total - dl_hits)
    sums = {}
    if ctr is not None:
        real = ctr[:n_real].double()
        for i, col in enumerate(ccols):
            if col == "residual":
                continue
            s = float(torch.nansum(real[:, i]))
            sums[col] = s
            obs.counter(f"region_solver_{col}").inc(s)
    if stats is not None:
        stats["cells_solved"] = stats.get("cells_solved", 0) + n_real
        stats["cells_converged"] = (stats.get("cells_converged", 0)
                                    + conv_real)
        stats["deadline_requests"] = (stats.get("deadline_requests", 0)
                                      + dl_total)
        stats["deadline_hits"] = stats.get("deadline_hits", 0) + dl_hits
        agg = stats.setdefault("solver_counters", {})
        for col, s in sums.items():
            agg[col] = agg.get(col, 0.0) + s
