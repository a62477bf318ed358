"""Admission layer: the request queue in front of the region pipeline.

Port of `repro/region/admission.py`, without the deprecated `{stage}_s`
aggregate properties of `StageClocks` (read `total(stage)` or
`as_dict()`).

Requests enter the pipeline here and wait — per bucket — until a
*batch-closing policy* decides their batch is worth dispatching. The queue
tracks per-request enqueue times, deadlines, and priorities; when a batch
closes, its members are handed to the planning layer in
(priority desc, arrival) order and their queue wait is charged to the
pipeline's `StageClocks`.

Policies (`AllocationRequest.deadline`/`priority` feed them):

  * `CloseOnFull`   — close only when `cells_per_batch` requests are
    queued (plus the forced close of a `flush`). The throughput-greedy
    default: every dispatched chunk is fully occupied, so the compiled
    batch shape never solves avoidable pad cells.
  * `MaxWait`       — close-on-full OR when the oldest queued request has
    waited `max_wait` (in the caller's clock units — wall seconds with the
    default clock, logical ticks if the caller passes its own `now`).
    Bounds queue latency under trickle traffic.
  * `DeadlineSlack` — close-on-full OR when any queued request's deadline
    is within `slack` of `now`. The SLO-shaped policy: a batch closes
    exactly early enough for its tightest request.

The clock is caller-defined: every entry point takes `now` (defaulting to
`time.monotonic()`), so tests and benchmarks can drive the policies with
logical ticks and deadlines stay in one consistent unit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Hashable, List, Optional, Tuple

from .. import obs
from ..core.types import SystemParams, Weights
from .batch import DEFAULT_MIN_BUCKET, bucket_size


@dataclasses.dataclass
class AllocationRequest:
    """One cell asking for a (re-)allocation against its current channel
    snapshot. `cell_id` keys the warm-start cache: re-requests of the same
    cell (drifted gains, same device pool) re-solve from the previous
    solution. `w`, if set, overrides the allocator's default weights for
    this request only (traced — never a recompile). `deadline` (absolute,
    in the admission clock's units) and `priority` (larger first) feed the
    batch-closing policy and the within-batch ordering."""
    cell_id: Hashable
    sys: SystemParams
    w: Optional[Weights] = None
    deadline: Optional[float] = None
    priority: int = 0


class StageClocks:
    """Per-stage wall-time **samples** for the pipeline (seconds, except
    the queue_wait stage, which is in the admission clock's units — wall
    seconds unless the caller drives `now` itself).

      queue_wait : per request, batch close - submit
      plan       : per batch, host-side pad/stack/warm-init assembly
      dispatch   : per batch, host time to trace/enqueue the solve
      device     : per batch, dispatch -> compute observed ready (an upper
                   bound measured at the batch's first blocking poll)
      gather     : per batch, device->host materialization of responses

    Stages record individual durations via `record(stage, dur)` — the raw
    samples feed real latency distributions (`samples`, `histogram`,
    `percentiles`) instead of only a monotone sum, and each `record` also
    emits a `repro_torch.obs` "stage" point when a recorder is enabled.
    `as_dict()` sums every stage."""

    STAGES = ("queue_wait", "plan", "dispatch", "device", "gather")

    def __init__(self):
        self._samples: Dict[str, List[float]] = {s: [] for s in self.STAGES}

    def record(self, stage: str, dur: float) -> None:
        """Record one duration sample for `stage` (and, with a recorder
        enabled, emit it as an obs "stage" point)."""
        self._samples[stage].append(float(dur))
        if obs.enabled():
            obs.point("stage", stage=stage, dur_s=float(dur))

    def samples(self, stage: str) -> List[float]:
        """The stage's raw duration samples (a copy)."""
        return list(self._samples[stage])

    def total(self, stage: str) -> float:
        return float(sum(self._samples[stage]))

    def count(self, stage: str) -> int:
        return len(self._samples[stage])

    def histogram(self, stage: str):
        """The stage's samples in a fixed-bucket `obs` Histogram (the same
        layout every latency metric in the repo uses)."""
        h = obs.Histogram("stage_seconds", (("stage", stage),))
        h.observe_many(self._samples[stage])
        return h

    def percentiles(self, stage: str, qs=(50.0, 90.0, 99.0)) -> dict:
        """{p50: ..., p90: ..., p99: ...} of the stage's samples (NaN when
        the stage has none)."""
        return self.histogram(stage).percentiles(qs)

    def as_dict(self) -> dict:
        """Aggregate view: {stage}_s -> summed seconds."""
        return {f"{s}_s": self.total(s) for s in self.STAGES}

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v:.6g}" for k, v in self.as_dict().items())
        return f"StageClocks({body})"


@dataclasses.dataclass
class QueuedRequest:
    """A request waiting for its batch to close. `token` is an opaque
    caller payload carried through the queue — the pipeline stores the
    request's `PendingResponse` there so a closed batch can be bound back
    to the futures it serves."""
    request: AllocationRequest
    t_enqueue: float
    seq: int    # global arrival order: the FIFO tiebreak within a priority
    token: object = None


class BatchPolicy:
    """Decides when a bucket's pending requests close into a batch.

    `ready(queued, now, cells_per_batch)` sees the bucket's queue in
    arrival order and returns True to close a batch of (up to)
    `cells_per_batch` requests now. A forced `flush` closes everything
    regardless of the policy."""

    def ready(self, queued: List[QueuedRequest], now: float,
              cells_per_batch: int) -> bool:
        raise NotImplementedError


class CloseOnFull(BatchPolicy):
    """Close only full batches (flush drains the rest)."""

    def ready(self, queued, now, cells_per_batch):
        return len(queued) >= cells_per_batch


class MaxWait(BatchPolicy):
    """Close on full, or when the oldest request has waited `max_wait`."""

    def __init__(self, max_wait: float):
        if max_wait < 0:
            raise ValueError(f"MaxWait: max_wait must be >= 0, got {max_wait}")
        self.max_wait = float(max_wait)

    def ready(self, queued, now, cells_per_batch):
        if len(queued) >= cells_per_batch:
            return True
        return bool(queued) and now - queued[0].t_enqueue >= self.max_wait


class DeadlineSlack(BatchPolicy):
    """Close on full, or when any queued deadline is within `slack` of now.

    Requests without a deadline never trigger the early close (they ride
    along when a deadlined neighbor closes the batch, or when it fills)."""

    def __init__(self, slack: float = 0.0):
        self.slack = float(slack)

    def ready(self, queued, now, cells_per_batch):
        if len(queued) >= cells_per_batch:
            return True
        return any(q.request.deadline is not None
                   and q.request.deadline - now <= self.slack
                   for q in queued)


class AdmissionQueue:
    """Per-bucket request queues + the batch-closing policy.

    `submit` files a request under its device-count bucket;
    `close_ready(now)` asks the policy which batches to close and returns
    them as `(bucket, [QueuedRequest, ...])` groups — each at most
    `cells_per_batch` long, ordered by (priority desc, arrival), buckets in
    ascending order (the same deterministic grouping the synchronous
    `RegionAllocator.solve` always produced for equal priorities)."""

    def __init__(self, cells_per_batch: int,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 policy: Optional[BatchPolicy] = None,
                 clocks: Optional[StageClocks] = None):
        if cells_per_batch < 1:
            raise ValueError("cells_per_batch must be >= 1")
        self.cells_per_batch = int(cells_per_batch)
        self.min_bucket = int(min_bucket)
        self.policy = policy if policy is not None else CloseOnFull()
        self.clocks = clocks if clocks is not None else StageClocks()
        self._queues: Dict[int, List[QueuedRequest]] = {}
        self._seq = 0

    def submit(self, request: AllocationRequest,
               now: Optional[float] = None, token: object = None) -> int:
        """Queue a request; returns the bucket it was filed under."""
        now = time.monotonic() if now is None else now
        bucket = bucket_size(request.sys.n, self.min_bucket)
        self._queues.setdefault(bucket, []).append(
            QueuedRequest(request, now, self._seq, token))
        self._seq += 1
        return bucket

    @property
    def pending(self) -> int:
        """Requests queued but not yet closed into a batch."""
        return sum(len(q) for q in self._queues.values())

    def close_ready(self, now: Optional[float] = None, force: bool = False
                    ) -> List[Tuple[int, List[QueuedRequest]]]:
        """Close every batch the policy (or `force`) says is ready.

        Returns `(bucket, [QueuedRequest, ...])` groups — each at most
        `cells_per_batch` long, ordered by (priority desc, arrival),
        buckets ascending (the deterministic grouping the synchronous
        `RegionAllocator.solve` always produced for equal priorities)."""
        now = time.monotonic() if now is None else now
        closed: List[Tuple[int, List[QueuedRequest]]] = []
        for bucket in sorted(self._queues):
            queue = self._queues[bucket]
            while queue and (force or self.policy.ready(
                    queue, now, self.cells_per_batch)):
                # stable sort: FIFO within equal priorities, so the default
                # (all priority 0) reproduces pure arrival order
                queue.sort(key=lambda e: (-e.request.priority, e.seq))
                take = queue[:self.cells_per_batch]
                queue = queue[self.cells_per_batch:]
                self._queues[bucket] = queue
                late = 0
                for e in take:
                    self.clocks.record("queue_wait",
                                       max(0.0, now - e.t_enqueue))
                    if (e.request.deadline is not None
                            and e.request.deadline < now):
                        late += 1
                if late:
                    # the deadline expired while the request was still
                    # QUEUED — in the admission clock's own units, so the
                    # count is meaningful even under logical-tick clocks
                    # (unlike the completion layer's wall-clock hit check)
                    obs.counter("region_admission_deadline_late").inc(late)
                closed.append((bucket, take))
        return closed
