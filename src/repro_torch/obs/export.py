"""Exporters for the metrics registry: Prometheus text + metrics JSONL.

Port of `repro/obs/export.py`, unchanged: byte-identical Prometheus text
and the same JSONL records for the same registry operations.

Two renderings of the same `MetricsRegistry` snapshot:

  * `prometheus_text(registry)` — Prometheus text exposition format
    (counters as `*_total`, histograms as cumulative `_bucket{le=...}`
    series plus `_sum`/`_count`), suitable for a textfile collector or a
    scrape endpoint;
  * `metrics_jsonl(registry)` / `write_metrics_jsonl(path)` — one JSON
    object per metric with explicit percentiles, the format CI uploads
    as an artifact and a comparison script can diff.

Both snapshot under no lock beyond the registry's own accessors: metric
mutation is monotone, so a torn read is at worst one observation stale.
"""
from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, List, Optional, Tuple

from .metrics import MetricsRegistry, REGISTRY

__all__ = ["prometheus_text", "metrics_jsonl", "write_metrics_jsonl",
           "parse_prometheus_text"]


def _name(raw: str) -> str:
    """Prometheus metric names allow [a-zA-Z0-9_:] only."""
    return "".join(c if c.isalnum() or c in "_:" else "_" for c in raw)


def _labels(pairs, extra: str = "") -> str:
    parts = [f'{_name(k)}="{v}"' for k, v in pairs]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _num(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Render the registry in Prometheus text exposition format."""
    reg = registry if registry is not None else REGISTRY
    lines: List[str] = []
    seen_type = set()

    def header(name: str, kind: str):
        if name not in seen_type:
            seen_type.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for c in reg.counters():
        n = _name(c.name) + "_total"
        header(n, "counter")
        lines.append(f"{n}{_labels(c.labels)} {_num(c.value)}")

    for g in reg.gauges():
        n = _name(g.name)
        header(n, "gauge")
        lines.append(f"{n}{_labels(g.labels)} {_num(g.value)}")

    for h in reg.histograms():
        n = _name(h.name)
        header(n, "histogram")
        cum = 0
        for bound, count in zip(h.bounds, h.buckets):
            cum += count
            if count:   # sparse exposition: emit only occupied edges + +Inf
                le = 'le="%s"' % _num(bound)
                lines.append(f"{n}_bucket{_labels(h.labels, le)} {cum}")
        le_inf = 'le="+Inf"'
        lines.append(f"{n}_bucket{_labels(h.labels, le_inf)} {h.count}")
        lines.append(f"{n}_sum{_labels(h.labels)} {_num(h.sum)}")
        lines.append(f"{n}_count{_labels(h.labels)} {h.count}")
        if h.dropped:
            # non-finite observations excluded from the series above
            nd = n + "_dropped_total"
            header(nd, "counter")
            lines.append(f"{nd}{_labels(h.labels)} {h.dropped}")

    return "\n".join(lines) + ("\n" if lines else "")


_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_prometheus_text(text: str
                          ) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                                    float]:
    """Parse Prometheus text exposition back into
    `{(name, sorted (k, v) label pairs): value}` — the round-trip check
    for `prometheus_text` (scrape smoke tests, an SLO gate).

    Covers the subset this repo emits: one sample per line, `# TYPE`/`#`
    comment lines skipped, label values quoted without escapes. Malformed
    sample lines raise ValueError — a scrape endpoint that stops parsing
    should fail loudly."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"parse_prometheus_text: bad sample {line!r}")
        labels = tuple(sorted(
            (k, v) for k, v in _LABEL_RE.findall(m.group("labels") or "")))
        out[(m.group("name"), labels)] = float(m.group("value"))
    return out


def metrics_jsonl(registry: Optional[MetricsRegistry] = None
                  ) -> List[Dict[str, Any]]:
    """The registry as a list of JSON-ready dicts, one per metric.

    Histogram records carry derived p50/p90/p99 so downstream consumers
    (CI artifacts, comparison scripts) never re-implement bucket
    interpolation.
    """
    reg = registry if registry is not None else REGISTRY
    out: List[Dict[str, Any]] = []
    for c in reg.counters():
        out.append(dict(kind="counter", name=c.name, labels=dict(c.labels),
                        value=c.value))
    for g in reg.gauges():
        out.append(dict(kind="gauge", name=g.name, labels=dict(g.labels),
                        value=g.value))
    for h in reg.histograms():
        rec = dict(kind="histogram", name=h.name, labels=dict(h.labels),
                   count=h.count, sum=h.sum)
        if h.dropped:
            rec["dropped"] = h.dropped
        if h.count:
            rec.update(min=h.min, max=h.max, mean=h.mean,
                       **h.percentiles((50.0, 90.0, 99.0)))
        out.append(rec)
    return out


def write_metrics_jsonl(path: str,
                        registry: Optional[MetricsRegistry] = None) -> int:
    """Write `metrics_jsonl` records to `path`; returns the record count."""
    records = metrics_jsonl(registry)
    with open(path, "w") as fh:
        for rec in records:
            fh.write(json.dumps(rec))
            fh.write("\n")
    return len(records)
