"""Metrics registry: counters, gauges, and fixed-bucket latency histograms.

Port of `repro/obs/metrics.py`, unchanged: the same names, label model,
bucket bounds and percentile interpolation.

Unlike the span stream (recorder.py), metrics are always-on aggregates:
incrementing a counter or observing a histogram costs a dict lookup and a
float add whether or not a recorder is installed. They answer "what were
the p50/p90/p99 and totals of this run" without retaining per-event data.

Histograms use one fixed, log-spaced bucket layout (`DEFAULT_BOUNDS`)
shared by every latency metric in the repo, so histogram-derived
percentiles are comparable across runs. The bucket growth factor is ~7%
— below a 15% regression gate — so quantization error cannot mask or
fake a regression.

Identity is `(name, labels)` with labels a sorted tuple of `(k, v)`
pairs, mirroring the Prometheus data model; `export.prometheus_text`
renders the registry in text exposition format and
`export.metrics_jsonl` as one JSON object per metric.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "REGISTRY", "counter", "gauge", "histogram", "DEFAULT_BOUNDS",
]

LabelPairs = Tuple[Tuple[str, str], ...]


def _freeze(labels: Dict[str, str]) -> LabelPairs:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _log_bounds(lo: float, hi: float, factor: float) -> Tuple[float, ...]:
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * factor)
    return tuple(out)


# 100 µs .. ~100 s at ~7% growth (~200 buckets + overflow). Fixed for the
# whole repo: see module docstring for why the factor sits below a 15%
# regression gate.
DEFAULT_BOUNDS: Tuple[float, ...] = _log_bounds(1e-4, 100.0, 1.07)


@dataclass
class Counter:
    """Monotonic float total."""

    name: str
    labels: LabelPairs = ()
    value: float = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("Counter.inc amount must be >= 0")
        self.value += amount


@dataclass
class Gauge:
    """Last-write-wins instantaneous value."""

    name: str
    labels: LabelPairs = ()
    value: float = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    `bounds[i]` is the inclusive upper edge of bucket i; one overflow
    bucket catches everything above `bounds[-1]`. `percentile` linearly
    interpolates within the winning bucket, which is accurate to the
    bucket growth factor (~7% with `DEFAULT_BOUNDS`) — tight enough for
    the 15% regression gate, and stable because the layout never moves.

    Non-finite observations (NaN/inf — e.g. a latency computed from a
    clock that never ticked) are counted in `dropped` and excluded from
    every aggregate: a single NaN would otherwise defeat both min/max
    comparisons, land in an arbitrary bucket, and poison `sum`, `mean`,
    and every derived percentile for the rest of the run.
    """

    def __init__(self, name: str, labels: LabelPairs = (),
                 bounds: Sequence[float] = DEFAULT_BOUNDS):
        self.name = name
        self.labels = labels
        self.bounds: Tuple[float, ...] = tuple(bounds)
        self.buckets: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.dropped = 0

    def observe(self, value: float) -> None:
        v = float(value)
        if not math.isfinite(v):
            self.dropped += 1
            return
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self.buckets[self._index(v)] += 1

    def observe_many(self, values: Iterable[float]) -> None:
        for v in values:
            self.observe(v)

    def _index(self, v: float) -> int:
        lo, hi = 0, len(self.bounds)
        while lo < hi:          # first bound >= v (bisect on the edges)
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        return lo

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def percentile(self, q: float) -> float:
        """q in [0, 100]. NaN when empty; exact at the recorded min/max
        endpoints, bucket-interpolated in between."""
        if not self.count:
            return math.nan
        if q <= 0:
            return self.min
        if q >= 100:
            return self.max
        rank = q / 100.0 * self.count
        cum = 0
        for i, n in enumerate(self.buckets):
            if not n:
                continue
            prev_cum = cum
            cum += n
            if cum >= rank:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = self.bounds[i] if i < len(self.bounds) else self.max
                lo = max(lo, self.min) if lo < self.min <= hi else lo
                hi = min(hi, self.max) if lo <= self.max < hi else hi
                frac = (rank - prev_cum) / n
                return lo + (hi - lo) * frac
        return self.max

    def percentiles(self, qs: Sequence[float] = (50.0, 90.0, 99.0)
                    ) -> Dict[str, float]:
        return {f"p{q:g}": self.percentile(q) for q in qs}


class MetricsRegistry:
    """Process-wide store of metric instances keyed by (name, labels).

    `get`-style accessors create on first use, so instrumentation sites
    never need registration boilerplate. `reset()` drops everything —
    benches and tests call it between A/B arms.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelPairs], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelPairs], Gauge] = {}
        self._histograms: Dict[Tuple[str, LabelPairs], Histogram] = {}

    def counter(self, name: str, **labels: str) -> Counter:
        key = (name, _freeze(labels))
        with self._lock:
            m = self._counters.get(key)
            if m is None:
                m = self._counters[key] = Counter(name, key[1])
        return m

    def gauge(self, name: str, **labels: str) -> Gauge:
        key = (name, _freeze(labels))
        with self._lock:
            m = self._gauges.get(key)
            if m is None:
                m = self._gauges[key] = Gauge(name, key[1])
        return m

    def histogram(self, name: str, bounds: Sequence[float] = DEFAULT_BOUNDS,
                  **labels: str) -> Histogram:
        key = (name, _freeze(labels))
        with self._lock:
            m = self._histograms.get(key)
            if m is None:
                m = self._histograms[key] = Histogram(name, key[1], bounds)
        return m

    def counters(self) -> List[Counter]:
        return list(self._counters.values())

    def gauges(self) -> List[Gauge]:
        return list(self._gauges.values())

    def histograms(self) -> List[Histogram]:
        return list(self._histograms.values())

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


REGISTRY = MetricsRegistry()


def counter(name: str, **labels: str) -> Counter:
    """Get-or-create a counter in the global registry."""
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels: str) -> Gauge:
    """Get-or-create a gauge in the global registry."""
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels: str) -> Histogram:
    """Get-or-create a histogram (DEFAULT_BOUNDS) in the global registry."""
    return REGISTRY.histogram(name, **labels)
