"""`repro_torch.obs` — unified telemetry: spans, metrics, exporters, report.

Port of `repro.obs`, with the same exports. Two independent planes:

  * **event plane** (`recorder`): `span()` context managers and `point()`
    events streamed to an installable `Recorder` (memory / JSONL). Off by
    default — the no-op recorder makes every instrumentation site a
    single predicate check. An enabled span also enters
    `torch.profiler.record_function` (and an NVTX range on a CUDA build).
  * **metric plane** (`metrics` + `export`): always-on counters, gauges,
    and fixed-bucket latency histograms in a global registry, exported
    as Prometheus text or metrics JSONL.
  * **SLO & profiling plane** (`slo` + `http` + `profile`): declarative
    objectives with multi-window burn-rate verdicts evaluated over the
    metric plane, a stdlib background HTTP exporter (`GET /metrics`,
    `/healthz`, `/slo`), and opt-in torch.profiler trace sessions +
    counted-FLOP gauges.

Solver counters (BCD iterations, SP1/SP2 dual evals, convergence
residuals) live in `core/bcd.py` as the `counters` field of a result,
still on the device; the region completion layer reads them once per
batch and feeds them into this module's per-request events.

Typical use::

    from repro_torch import obs

    with obs.recording(obs.JsonlRecorder("events.jsonl")):
        with obs.span("serve", trace="poisson"):
            ... run the pipeline ...
    # then: python -m repro_torch.obs.report events.jsonl
"""
from .recorder import (
    Recorder, NoopRecorder, MemoryRecorder, JsonlRecorder, NOOP,
    enabled, get_recorder, set_recorder, recording,
    span, point, strip_timing, read_jsonl,
)
from .metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
    counter, gauge, histogram, DEFAULT_BOUNDS,
)
from .export import (prometheus_text, metrics_jsonl, write_metrics_jsonl,
                     parse_prometheus_text)
from .slo import (SLO, SloObserver, SloPlane, BurnWindow, DEFAULT_WINDOWS,
                  LatencyObjective, RatioObjective, default_slos)
from .http import MetricsServer
from . import profile

__all__ = [
    # recorder / spans
    "Recorder", "NoopRecorder", "MemoryRecorder", "JsonlRecorder", "NOOP",
    "enabled", "get_recorder", "set_recorder", "recording",
    "span", "point", "strip_timing", "read_jsonl",
    # metrics
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "DEFAULT_BOUNDS",
    # exporters
    "prometheus_text", "metrics_jsonl", "write_metrics_jsonl",
    "parse_prometheus_text",
    # SLO plane + wire surface + profiling
    "SLO", "SloObserver", "SloPlane", "BurnWindow", "DEFAULT_WINDOWS",
    "LatencyObjective", "RatioObjective", "default_slos",
    "MetricsServer", "profile",
]
