"""SLO plane: declarative objectives + multi-window burn-rate verdicts.

Port of `repro/obs/slo.py`, unchanged: the same objectives, windows,
burn-rate arithmetic, verdicts and published gauges.

The metric plane (`obs.metrics`) already aggregates everything a serving
deployment produces — fixed-bucket latency histograms, deadline and
convergence counters. This module evaluates *objectives* directly over
those aggregates, Google-SRE style:

  * an `SLO` binds a name, a target good-event ratio (`objective`, e.g.
    0.99 -> a 1% error budget), a **source** that reads cumulative
    `(good, total)` event counts out of a `MetricsRegistry`, and a set of
    `BurnWindow`s;
  * `SloPlane.check(now)` snapshots every source, computes the burn rate
    over each window — ``(bad_delta / total_delta) / error_budget``, i.e.
    how many times faster than "exactly on budget" the budget is being
    spent — and returns JSON-ready verdicts. A window with no traffic
    burns at 0. The verdict is the classic multi-window AND: ``breach``
    only when EVERY window exceeds its `max_burn_rate` (fast window =
    it's happening now, slow window = it's not a blip), ``warn`` when
    some but not all do, ``ok`` otherwise, ``no_data`` before the first
    event.

Sources (both pure registry reads — no device work):

  * `LatencyObjective`: good = observations at or under `threshold_s` in
    a histogram. The threshold snaps UP to the nearest bucket edge of the
    shared `DEFAULT_BOUNDS` layout (<= ~7%, the bucket growth factor), so
    the count is exact with respect to the snapped threshold.
  * `RatioObjective`: good/total from two counters (deadline hits vs
    deadlined requests, converged cells vs solved cells, ...).

Windows are measured on the caller's clock: every `observe`/`check`
takes `now` (default `time.monotonic()`), so tests drive burn-rate math
with logical ticks. `check` also publishes its verdicts back into the
registry (`slo_good_ratio`, `slo_burn_rate{window=...}`,
`slo_budget_remaining`, `slo_breaching` gauges) so a `/metrics` scrape
sees SLO state next to the raw series.

`default_slos()` returns the repo's three serving objectives (p99 solve
latency, request deadline-hit rate, per-round BCD convergence rate) over
the metric names the region completion layer maintains.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .metrics import Histogram, MetricsRegistry, REGISTRY

__all__ = [
    "BurnWindow", "DEFAULT_WINDOWS", "LatencyObjective", "RatioObjective",
    "SLO", "SloObserver", "SloPlane", "default_slos",
]


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One burn-rate alerting window: the budget-spend rate averaged over
    the trailing `seconds` must stay under `max_burn_rate` (1.0 = spending
    exactly the whole budget over the objective period)."""
    name: str
    seconds: float
    max_burn_rate: float


# fast window catches an active incident, slow window filters blips —
# the standard 14.4x/6x pair scaled to serving-bench horizons
DEFAULT_WINDOWS: Tuple[BurnWindow, ...] = (
    BurnWindow("fast", 60.0, 14.4),
    BurnWindow("slow", 600.0, 6.0),
)


@dataclasses.dataclass(frozen=True)
class LatencyObjective:
    """good = histogram observations <= `threshold_s` (snapped up to the
    next bucket edge); total = all finite observations. `labels` must
    match the instrument site exactly (sorted (k, v) pairs)."""
    metric: str
    threshold_s: float
    labels: Tuple[Tuple[str, str], ...] = ()

    def counts(self, registry: MetricsRegistry) -> Tuple[float, float]:
        h: Histogram = registry.histogram(self.metric, **dict(self.labels))
        good = 0
        for bound, n in zip(h.bounds, h.buckets):
            good += n
            if bound >= self.threshold_s:
                break
        else:
            good = h.count   # threshold above the layout: everything good
        return float(good), float(h.count)

    def describe(self) -> Dict[str, object]:
        return dict(kind="latency", metric=self.metric,
                    threshold_s=self.threshold_s, labels=dict(self.labels))


@dataclasses.dataclass(frozen=True)
class RatioObjective:
    """good/total from two cumulative counters (e.g. deadline hits over
    deadlined requests)."""
    good_metric: str
    total_metric: str
    labels: Tuple[Tuple[str, str], ...] = ()

    def counts(self, registry: MetricsRegistry) -> Tuple[float, float]:
        lbl = dict(self.labels)
        return (registry.counter(self.good_metric, **lbl).value,
                registry.counter(self.total_metric, **lbl).value)

    def describe(self) -> Dict[str, object]:
        return dict(kind="ratio", good_metric=self.good_metric,
                    total_metric=self.total_metric, labels=dict(self.labels))


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative objective: `source.counts(registry)` must keep its
    good ratio at or above `objective` (error budget = 1 - objective)."""
    name: str
    objective: float
    source: object               # LatencyObjective | RatioObjective | duck
    windows: Tuple[BurnWindow, ...] = DEFAULT_WINDOWS

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO {self.name!r}: objective must be in (0, 1), got "
                f"{self.objective} (1.0 leaves a zero error budget — no "
                f"finite burn rate exists)")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.objective


class SloPlane:
    """Evaluates a set of `SLO`s over one registry with windowed history.

    The plane keeps, per SLO, a ring of `(t, good, total)` snapshots taken
    by `observe()` (call it from the serving loop — once per flush/poll is
    plenty) and closed by `check()`. Burn rates difference the latest
    snapshot against the newest sample at least `window.seconds` old; a
    ring that doesn't yet span the window falls back to its oldest sample
    (the whole observed history), so short traces still get verdicts.
    """

    def __init__(self, slos: Sequence[SLO],
                 registry: Optional[MetricsRegistry] = None,
                 max_samples: int = 4096):
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"SloPlane: duplicate SLO names in {names}")
        self.slos: Tuple[SLO, ...] = tuple(slos)
        self.registry = registry if registry is not None else REGISTRY
        self.max_samples = int(max_samples)
        self._rings: Dict[str, List[Tuple[float, float, float]]] = {
            s.name: [] for s in self.slos}

    # ------------------------------------------------------------ sampling
    def observe(self, now: Optional[float] = None) -> None:
        """Snapshot every SLO's cumulative (good, total) at `now`."""
        now = time.monotonic() if now is None else float(now)
        for slo in self.slos:
            good, total = slo.source.counts(self.registry)
            ring = self._rings[slo.name]
            ring.append((now, float(good), float(total)))
            if len(ring) > self.max_samples:
                # decimate the old half: keeps coverage of long horizons
                # without unbounded memory
                del ring[1:len(ring) // 2:2]

    # ------------------------------------------------------------ verdicts
    def check(self, now: Optional[float] = None) -> List[Dict[str, object]]:
        """Evaluate every SLO; returns JSON-ready verdict dicts (and
        mirrors them into `slo_*` gauges in the registry)."""
        now = time.monotonic() if now is None else float(now)
        self.observe(now)
        out: List[Dict[str, object]] = []
        for slo in self.slos:
            out.append(self._check_one(slo, now))
        return out

    def _check_one(self, slo: SLO, now: float) -> Dict[str, object]:
        ring = self._rings[slo.name]
        t_last, good, total = ring[-1]
        budget = slo.error_budget
        windows = []
        n_breach = 0
        for w in slo.windows:
            t0, g0, n0 = self._sample_at(ring, now - w.seconds)
            dg, dn = good - g0, total - n0
            burn = ((dn - dg) / dn) / budget if dn > 0 else 0.0
            breach = burn > w.max_burn_rate
            n_breach += bool(breach)
            windows.append(dict(name=w.name, seconds=w.seconds,
                                burn_rate=burn,
                                max_burn_rate=w.max_burn_rate,
                                breach=breach))
        if total <= 0:
            verdict = "no_data"
            good_ratio = None
            budget_remaining = None
        else:
            good_ratio = good / total
            budget_remaining = 1.0 - (1.0 - good_ratio) / budget
            verdict = ("breach" if n_breach == len(windows) and windows
                       else "warn" if n_breach else "ok")
        self._publish(slo, good_ratio, budget_remaining, windows, verdict)
        return dict(name=slo.name, objective=slo.objective,
                    source=slo.source.describe(),
                    good=good, total=total, good_ratio=good_ratio,
                    budget_remaining=budget_remaining,
                    windows=windows, verdict=verdict)

    @staticmethod
    def _sample_at(ring, t: float) -> Tuple[float, float, float]:
        """The newest sample no newer than `t` (the window-start state);
        the oldest sample when the ring doesn't reach back that far."""
        best = ring[0]
        for s in ring:
            if s[0] > t:
                break
            best = s
        return best

    def _publish(self, slo: SLO, good_ratio, budget_remaining, windows,
                 verdict: str) -> None:
        reg = self.registry
        if good_ratio is not None:
            reg.gauge("slo_good_ratio", slo=slo.name).set(good_ratio)
            reg.gauge("slo_budget_remaining",
                      slo=slo.name).set(budget_remaining)
        for w in windows:
            reg.gauge("slo_burn_rate", slo=slo.name,
                      window=w["name"]).set(w["burn_rate"])
        reg.gauge("slo_breaching",
                  slo=slo.name).set(1.0 if verdict == "breach" else 0.0)
        reg.counter("slo_checks", slo=slo.name).inc()


class SloObserver:
    """Timer-driven `SloPlane.observe()` on a daemon thread.

    Burn-rate windows need *regularly spaced* ring samples: a plane only
    sampled from the serving loop goes blind exactly when serving stalls —
    the incident the SLOs exist to catch. The observer decouples sampling
    from traffic: every `period_s` it calls `plane.observe(clock())`.

    * `clock` is injectable (default `time.monotonic`): tests drive
      burn-rate math with logical ticks and never sleep through windows.
    * the loop waits on a `threading.Event`, so `stop()` interrupts a
      sleeping observer immediately — no stray period-length hang at
      shutdown (`MetricsServer` stops its observer on exit).
    * sampling is pure registry reads (no device work), so a
      short period is cheap; `ticks` counts completed observations.

    Use standalone (`start()`/`stop()`, or as a context manager) or let
    `MetricsServer(observe_period_s=...)` own one.
    """

    def __init__(self, plane: SloPlane, period_s: float = 5.0,
                 clock=None):
        if period_s <= 0:
            raise ValueError(
                f"SloObserver: period_s must be positive, got {period_s}")
        self.plane = plane
        self.period_s = float(period_s)
        self.clock = clock if clock is not None else time.monotonic
        self.ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run(self) -> None:
        # one sample up front: short-lived runs still get a ring entry
        while True:
            self.plane.observe(self.clock())
            self.ticks += 1
            if self._stop.wait(self.period_s):
                return

    def start(self) -> "SloObserver":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="slo-observer")
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self) -> "SloObserver":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


def default_slos(latency_threshold_s: float = 0.5,
                 latency_objective: float = 0.99,
                 deadline_objective: float = 0.95,
                 convergence_objective: float = 0.90,
                 windows: Tuple[BurnWindow, ...] = DEFAULT_WINDOWS
                 ) -> Tuple[SLO, ...]:
    """The repo's three serving objectives over the metric names the
    region completion layer maintains (`region.completion`):

      * serve_latency_p99 — request latency under `latency_threshold_s`
        for `latency_objective` of requests;
      * deadline_hit_rate — deadlined requests materialized before their
        deadline;
      * bcd_convergence   — cells whose BCD solve converged.
    """
    return (
        SLO("serve_latency_p99", latency_objective,
            LatencyObjective("region_request_latency_seconds",
                             latency_threshold_s), windows),
        SLO("deadline_hit_rate", deadline_objective,
            RatioObjective("region_deadline_hits",
                           "region_deadline_requests"), windows),
        SLO("bcd_convergence", convergence_objective,
            RatioObjective("region_solve_converged_cells",
                           "region_solve_cells"), windows),
    )
