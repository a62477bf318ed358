"""`python -m repro_torch.obs.report` — summarize a recorded JSONL event
stream.

Port of `repro/obs/report.py`, unchanged. Reads the span/point events
written by `JsonlRecorder` (e.g. by a `RegionPipeline` serve under
`obs.recording`) and prints:

  * per-span-name latency tables: count, p50/p90/p99, mean, max —
    rebuilt through the same fixed-bucket `Histogram` the live metrics
    use, so the report and the Prometheus/JSONL exports agree;
  * per-stage tables from "stage" points (the region pipeline's
    queue_wait/plan/dispatch/device/gather samples);
  * per-request solver-effort counters from "request" points: BCD
    iterations, SP1/SP2 dual evals, final residual, end-to-end latency;
  * a deadline-hit line when any request carried a deadline (the
    completion layer stamps `deadline_hit` on those "request" points —
    the same facts the SLO plane's deadline-hit-rate objective counts).

Usage:
    python -m repro_torch.obs.report events.jsonl
    python -m repro_torch.obs.report events.jsonl --percentiles 50,95,99.9
"""
from __future__ import annotations

import argparse
import math
import sys
from collections import defaultdict
from typing import Any, Dict, Iterable, List, Sequence

from .metrics import Histogram
from .recorder import read_jsonl

__all__ = ["summarize", "format_report", "main"]

_MS = 1e3


def _hist_of(values: Iterable[float]) -> Histogram:
    h = Histogram("report")
    h.observe_many(values)
    return h


def summarize(events: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate an event stream into the report's table inputs.

    Returns {"spans": {name: Histogram_of_dur_s},
             "stages": {stage: Histogram_of_dur_s},
             "requests": {"latency": Histogram, "counters": {k: [v...]}},
             "deadlines": {"hits": int, "total": int},
             "counts": {event name: occurrences}}.
    """
    span_durs: Dict[str, List[float]] = defaultdict(list)
    stage_durs: Dict[str, List[float]] = defaultdict(list)
    req_lat: List[float] = []
    req_counters: Dict[str, List[float]] = defaultdict(list)
    counts: Dict[str, int] = defaultdict(int)
    dl_hits = dl_total = 0

    for ev in events:
        counts[ev.get("name", "?")] += 1
        t = ev.get("type")
        if t == "span":
            span_durs[ev["name"]].append(float(ev.get("dur_s", 0.0)))
        elif t == "point" and ev.get("name") == "stage":
            stage_durs[ev["stage"]].append(float(ev.get("dur_s", 0.0)))
        elif t == "point" and ev.get("name") == "request":
            if "latency_s" in ev:
                req_lat.append(float(ev["latency_s"]))
            if "deadline_hit" in ev:
                dl_total += 1
                dl_hits += bool(ev["deadline_hit"])
            for k, v in ev.items():
                if k in ("type", "name", "span", "parent") or k == "ts":
                    continue
                if isinstance(v, (int, float)) and not k.endswith("_s"):
                    req_counters[k].append(float(v))

    return {
        "spans": {k: _hist_of(v) for k, v in sorted(span_durs.items())},
        "stages": {k: _hist_of(v) for k, v in sorted(stage_durs.items())},
        "requests": {"latency": _hist_of(req_lat),
                     "counters": dict(sorted(req_counters.items()))},
        "deadlines": {"hits": dl_hits, "total": dl_total},
        "counts": dict(counts),
    }


def _table(title: str, rows: List[List[str]], header: List[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    fmt = "  ".join("{:>%d}" % w for w in widths)
    out = [title, fmt.format(*header)]
    out += [fmt.format(*r) for r in rows]
    return "\n".join(out)


def _lat_rows(hists: Dict[str, Histogram], qs: Sequence[float]
              ) -> List[List[str]]:
    rows = []
    for name, h in hists.items():
        if not h.count:
            continue
        row = [name, str(h.count)]
        row += [f"{h.percentile(q) * _MS:.3f}" for q in qs]
        row += [f"{h.mean * _MS:.3f}", f"{h.max * _MS:.3f}"]
        rows.append(row)
    return rows


def format_report(summary: Dict[str, Any],
                  qs: Sequence[float] = (50.0, 90.0, 99.0)) -> str:
    """Render the `summarize` output as aligned text tables (ms units)."""
    header = ["name", "n"] + [f"p{q:g}_ms" for q in qs] + ["mean_ms", "max_ms"]
    blocks: List[str] = []

    span_rows = _lat_rows(summary["spans"], qs)
    if span_rows:
        blocks.append(_table("== spans ==", span_rows, header))

    stage_rows = _lat_rows(summary["stages"], qs)
    if stage_rows:
        blocks.append(_table("== pipeline stages ==", stage_rows, header))

    req = summary["requests"]
    if req["latency"].count:
        blocks.append(_table(
            "== request latency ==",
            _lat_rows({"end_to_end": req["latency"]}, qs), header))

    ctr_rows = []
    for k, vals in req["counters"].items():
        h = _hist_of(vals)
        ctr_rows.append([k, str(h.count), f"{h.mean:.3f}",
                         f"{h.percentile(50):.3f}", f"{h.max:.3f}"])
    if ctr_rows:
        blocks.append(_table("== per-request solver counters ==",
                             ctr_rows, ["counter", "n", "mean", "p50", "max"]))

    dl = summary.get("deadlines", {"total": 0})
    if dl["total"]:
        blocks.append(f"== deadlines == {dl['hits']}/{dl['total']} hit "
                      f"({100.0 * dl['hits'] / dl['total']:.1f}%)")

    if not blocks:
        blocks.append("(no span/stage/request events found)")
    return "\n\n".join(blocks) + "\n"


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a repro_torch.obs JSONL event stream.")
    ap.add_argument("events", help="path to a JSONL event file")
    ap.add_argument("--percentiles", default="50,90,99",
                    help="comma-separated percentiles (default 50,90,99)")
    args = ap.parse_args(argv)

    qs = tuple(float(q) for q in args.percentiles.split(","))
    events = read_jsonl(args.events)
    sys.stdout.write(format_report(summarize(events), qs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
