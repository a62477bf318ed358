"""Planning layer: turn a closed batch of requests into one solve-ready plan.

Port of `repro/region/planning.py`. Group requests by power-of-two device
bucket (`group_requests`, buckets ascending, arrival order within a
bucket), then assemble each chunk into a fixed-shape `BatchPlan`:

  * every cell's pool is padded to the bucket with masked devices
    (`pad_system`) and warm-started from the `WarmStartCache` when its
    previous solution is still pool-compatible;
  * short chunks are padded to `cells_per_batch` with **all-inactive filler
    cells** (`inactive_system`): a fully masked cell sits at the masked
    fixed point, so its BCD lane's rel-step is exactly 0 and it reports
    convergence after ONE iteration. Real lanes are unaffected (cells are
    independent);
  * per-request weights are collected into the (C, 3) weights list (pad
    lanes carry the planner's default weights — sliced off).

All assembly here happens on the host (`device="cpu"` of `pad_system` /
`pad_allocation` / `inactive_system`, and `initial_allocation` /
`stack_systems` on host tensors): padding and stacking are pure data
movement, and small ops on the card would each cost a launch. The
finished batch moves to the pipeline's device once (one copy per
tensor). The warm-start cache keeps host tensors. Host time spent in
`plan()` is charged to the "plan" stage of `StageClocks`.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import torch

from ..core.bcd import initial_allocation, stack_systems
from ..core.types import ALLOC_FIELDS, Allocation, SystemParams, Weights
from .admission import AllocationRequest, StageClocks
from .batch import (DEFAULT_MIN_BUCKET, bucket_size, inactive_system,
                    pad_allocation, pad_system)

_HOST = torch.device("cpu")


class WarmStartCache:
    """LRU of previous solutions keyed by cell id: cell_id -> (n, Allocation),
    the allocation's tensors on the host.

    A re-request of a known cell whose device pool is unchanged warm-starts
    from its last solution (~2 BCD iterations instead of a cold ~4-8). A
    re-request with a *resized* pool can never use the cached solution (the
    shapes differ), so the lookup purges the dead entry immediately instead
    of letting it occupy LRU capacity until overwritten (`resize_purges`
    counts these).
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("WarmStartCache: capacity must be >= 1")
        self.capacity = int(capacity)
        self._entries: "OrderedDict[Hashable, Tuple[int, Allocation]]" = \
            OrderedDict()
        self.hits = 0
        self.misses = 0
        self.resize_purges = 0
        self.evictions = 0
        self.handover_purges = 0

    def lookup(self, cell_id: Hashable, n: int) -> Optional[Allocation]:
        """The cell's cached solution if still pool-compatible, else None
        (purging a stale entry whose pool was resized)."""
        cached = self._entries.get(cell_id)
        if cached is None:
            self.misses += 1
            return None
        if cached[0] != n:
            # the dead entry would never be served again — free its slot now
            del self._entries[cell_id]
            self.resize_purges += 1
            self.misses += 1
            return None
        self._entries.move_to_end(cell_id)
        self.hits += 1
        return cached[1]

    def purge(self, cell_id: Hashable) -> bool:
        """Drop a cell's entry outright (mobility handover: the member set
        changed, so the cached solution maps to the wrong devices — even a
        same-size pool must cold-start). Counted in `handover_purges`;
        returns whether an entry was actually dropped."""
        if cell_id in self._entries:
            del self._entries[cell_id]
            self.handover_purges += 1
            return True
        return False

    def store(self, cell_id: Hashable, n: int, alloc: Allocation) -> None:
        self._entries[cell_id] = (int(n), alloc)
        self._entries.move_to_end(cell_id)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, cell_id: Hashable) -> bool:
        return cell_id in self._entries


@dataclasses.dataclass
class BatchPlan:
    """One solve-ready batch: fixed (cells_per_batch, bucket) shapes, on
    the pipeline's device.

    `requests`/`warm` cover only the `n_real` real lanes (in solve order);
    lanes `n_real..C-1` are all-inactive filler cells."""
    requests: List[AllocationRequest]
    bucket: int
    sys_batch: SystemParams      # (C, bucket) tensors
    init_batch: Allocation       # (C, bucket) tensors, (C,) T
    weights: List[Weights]       # length C
    warm: List[bool]             # length n_real
    n_real: int


def group_requests(requests: Sequence[AllocationRequest],
                   cells_per_batch: int,
                   min_bucket: int = DEFAULT_MIN_BUCKET
                   ) -> List[Tuple[int, List[AllocationRequest]]]:
    """The synchronous grouping: by device-count bucket (ascending), chunked
    to `cells_per_batch` in arrival order. Each `(bucket, chunk)` is one
    batch shape."""
    by_bucket: Dict[int, List[AllocationRequest]] = {}
    for r in requests:
        by_bucket.setdefault(bucket_size(r.sys.n, min_bucket), []).append(r)
    out: List[Tuple[int, List[AllocationRequest]]] = []
    for bucket in sorted(by_bucket):
        group = by_bucket[bucket]
        for i in range(0, len(group), cells_per_batch):
            out.append((bucket, group[i:i + cells_per_batch]))
    return out


def _full_allocation(init: Allocation) -> Allocation:
    """Normalize a warm/cold init to carry s_relaxed and a 0-d T."""
    if init.s_relaxed is not None and init.T is not None:
        return init
    return Allocation(
        bandwidth=init.bandwidth, power=init.power,
        freq=init.freq, resolution=init.resolution,
        s_relaxed=init.resolution if init.s_relaxed is None
        else init.s_relaxed,
        T=torch.zeros((), dtype=init.bandwidth.dtype,
                      device=init.bandwidth.device)
        if init.T is None else init.T)


def _stack_allocations(inits: Sequence[Allocation]) -> Allocation:
    return Allocation(**{k: torch.stack([getattr(a, k) for a in inits])
                         for k in ALLOC_FIELDS})


class BatchPlanner:
    """Assemble `(bucket, chunk)` groups into fixed-shape `BatchPlan`s on
    `device`.

    Owns the warm-start policy (via the shared `WarmStartCache`) and the
    pad-lane strategy; charges its host time to the "plan" stage.
    """

    def __init__(self, w: Weights, cache: WarmStartCache,
                 cells_per_batch: int,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 clocks: Optional[StageClocks] = None,
                 device: torch.device = _HOST):
        if cells_per_batch < 1:
            raise ValueError("cells_per_batch must be >= 1")
        self.w = w
        self.cache = cache
        self.cells_per_batch = int(cells_per_batch)
        self.min_bucket = int(min_bucket)
        self.clocks = clocks if clocks is not None else StageClocks()
        self.device = torch.device(device)

    def group(self, requests: Sequence[AllocationRequest]
              ) -> List[Tuple[int, List[AllocationRequest]]]:
        return group_requests(requests, self.cells_per_batch,
                              self.min_bucket)

    def plan(self, chunk: Sequence[AllocationRequest],
             bucket: int) -> BatchPlan:
        """Pad/stack one chunk (<= cells_per_batch requests of one bucket)
        on the host into a solve-ready plan, then move it to the device.
        Warm flags reflect the cache at *plan* time — the pipeline must not
        plan a cell whose previous solve is still in flight (see
        `RegionPipeline._dirty`)."""
        t0 = time.monotonic()
        C = self.cells_per_batch
        if not 0 < len(chunk) <= C:
            raise ValueError(
                f"plan: chunk of {len(chunk)} requests for "
                f"cells_per_batch={C}")
        padded = [pad_system(r.sys, bucket, device=_HOST) for r in chunk]
        inits: List[Allocation] = []
        warm: List[bool] = []
        weights = [r.w if r.w is not None else self.w for r in chunk]
        for r, ps in zip(chunk, padded):
            cached = self.cache.lookup(r.cell_id, r.sys.n)
            if cached is None:
                inits.append(_full_allocation(initial_allocation(ps)))
                warm.append(False)
            else:
                inits.append(_full_allocation(
                    pad_allocation(cached, bucket, ps, device=_HOST)))
                warm.append(True)
        n_real = len(chunk)
        if n_real < C:
            # all-inactive filler lanes: converge in one masked iteration
            filler_sys = inactive_system(padded[0], device=_HOST)
            filler_init = _full_allocation(initial_allocation(filler_sys))
            padded.extend([filler_sys] * (C - n_real))
            inits.extend([filler_init] * (C - n_real))
            weights.extend([self.w] * (C - n_real))
        sys_batch = stack_systems(padded).to(self.device)
        init_batch = _stack_allocations(inits).to(self.device)
        self.clocks.record("plan", time.monotonic() - t0)
        return BatchPlan(requests=list(chunk), bucket=int(bucket),
                         sys_batch=sys_batch, init_batch=init_batch,
                         weights=weights, warm=warm, n_real=n_real)
