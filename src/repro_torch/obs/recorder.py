"""Span/trace recorder: the event stream side of `repro_torch.obs`.

Port of `repro/obs/recorder.py`: the same events, schema, recorders and
deterministic ids. Where the reference names a span for XLA profiles
(`jax.named_scope` + `TraceAnnotation`), a span here enters
`torch.profiler.record_function(name)` and, on a CUDA build of torch, an
NVTX range of the same name.

A *span* is a named, timed region of host code (`with obs.span("plan")`),
nested via a per-thread stack into parent/child trees; a *point* is an
instantaneous structured event (`obs.point("request", cell_id=...)`).
Both are emitted to the installed `Recorder` as plain dicts — one JSON
object per event in the JSONL sinks — and are attributed to the enclosing
span through deterministic integer ids.

The default recorder is `NOOP`: `span()` then returns one cached null
context manager and `point()` returns immediately, so instrumented hot
paths cost a single global load + attribute check per site and allocate
nothing.

When a recorder IS enabled, spans additionally enter
`torch.profiler.record_function(name)` (and `torch.cuda.nvtx.range_push`
on a CUDA build), so every launch made inside a span shows up under the
span's name in a `torch.profiler` trace (and in an NVTX timeline). Neither
changes a result bit or a launch count. Entering a span is host-side
bookkeeping only; it never blocks on device work.

Event schema conventions (relied on by `obs.report` and the determinism
tests):

  * every event has `"type"` ("span" | "point"), `"name"`, `"span"` (its
    own id for spans, the enclosing span id for points; -1 at top level),
    and `"parent"` (enclosing span id, -1 at top level);
  * wall-clock fields are exactly `"ts"` (absolute seconds) and keys
    ending in `"_s"` (durations/offsets): `strip_timing` drops them, and
    everything that remains must be bit-deterministic for same-seed runs
    (tested) — do not put nondeterministic payloads in other keys;
  * span/event ids restart from 0 whenever a recorder is installed
    (`set_recorder`), so two same-seed runs emit identical id sequences.
"""
from __future__ import annotations

import json
import queue as _queue
import threading
import time
from typing import Any, Dict, List, Optional

import torch

__all__ = [
    "Recorder", "NoopRecorder", "MemoryRecorder", "JsonlRecorder",
    "NOOP", "enabled", "get_recorder", "set_recorder", "recording",
    "span", "point", "strip_timing", "TIMING_KEY", "read_jsonl",
]


def TIMING_KEY(key: str) -> bool:
    """Is `key` a wall-clock field (excluded from determinism contracts)?"""
    return key == "ts" or key.endswith("_s")


def strip_timing(event: Dict[str, Any]) -> Dict[str, Any]:
    """The deterministic projection of an event: drop `ts` and `*_s`."""
    return {k: v for k, v in event.items() if not TIMING_KEY(k)}


class Recorder:
    """Event sink base class. `enabled` gates every instrumentation site:
    a disabled recorder must never receive `emit`."""

    enabled: bool = False

    def emit(self, event: Dict[str, Any]) -> None:   # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass


class NoopRecorder(Recorder):
    """The default: drops everything, `enabled` False."""

    def emit(self, event):   # pragma: no cover - never called when wired
        pass


class MemoryRecorder(Recorder):
    """Buffers events in `self.events` (a list of dicts) — the test/report
    recorder, and the cheapest enabled sink."""

    enabled = True

    def __init__(self):
        self.events: List[Dict[str, Any]] = []

    def emit(self, event):
        self.events.append(event)


class JsonlRecorder(Recorder):
    """Streams one JSON object per line to `path` (append mode so several
    runs can share a trace file; pass `fresh=True` to truncate).

    Writes happen on a dedicated daemon writer thread fed by a bounded
    queue: `emit` on the serving thread is one non-blocking `put` (JSON
    serialization AND the file write are both off the hot path). A full
    queue — the writer can't keep up — drops the event and counts it in
    `dropped_events` (mirrored to the `obs_events_dropped` counter in the
    global metrics registry) instead of stalling the pipeline. `close()`
    flushes: it joins the writer after a sentinel, so every queued event
    is on disk when `obs.recording(...)` exits. Events keep their emit
    order — a single writer drains the queue FIFO."""

    enabled = True

    _SENTINEL = object()

    def __init__(self, path: str, fresh: bool = True,
                 queue_size: int = 8192):
        self.path = path
        self.dropped_events = 0
        self._fh = open(path, "w" if fresh else "a")
        self._queue: _queue.Queue = _queue.Queue(maxsize=int(queue_size))
        self._closed = False
        # test hook: clearing this gate stalls the writer so queue-full
        # drops become deterministic; set by default (a no-op wait)
        self._drain_gate = threading.Event()
        self._drain_gate.set()
        self._writer = threading.Thread(target=self._drain, daemon=True,
                                        name="obs-jsonl-writer")
        self._writer.start()

    def emit(self, event):
        if self._closed:
            self._count_drop()
            return
        try:
            self._queue.put_nowait(event)
        except _queue.Full:
            self._count_drop()

    def _count_drop(self) -> None:
        self.dropped_events += 1
        from .metrics import counter

        counter("obs_events_dropped").inc()

    def _drain(self) -> None:
        while True:
            event = self._queue.get()
            self._drain_gate.wait()
            if event is self._SENTINEL:
                return
            self._fh.write(json.dumps(event, default=_json_default))
            self._fh.write("\n")

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._queue.put(self._SENTINEL)   # blocking: the flush marker
        self._writer.join()
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()


def _json_default(x):
    """Last-resort JSON coercion: numpy/torch scalars -> python, else
    repr."""
    item = getattr(x, "item", None)
    if item is not None:
        try:
            return item()
        except (TypeError, ValueError):
            pass
    return repr(x)


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a JSONL event stream (skips blank lines)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# ---------------------------------------------------------------------------
# global recorder + span stack
# ---------------------------------------------------------------------------

NOOP = NoopRecorder()
_RECORDER: Recorder = NOOP

_tls = threading.local()


def _stack() -> List[int]:
    st = getattr(_tls, "spans", None)
    if st is None:
        st = _tls.spans = []
    return st


class _Ids:
    """Deterministic event/span id allocator, reset on recorder install."""

    def __init__(self):
        self.next = 0
        self.lock = threading.Lock()

    def take(self) -> int:
        with self.lock:
            i = self.next
            self.next += 1
        return i


_IDS = _Ids()


def get_recorder() -> Recorder:
    return _RECORDER


def enabled() -> bool:
    return _RECORDER.enabled


def set_recorder(rec: Optional[Recorder]) -> Recorder:
    """Install `rec` (None -> the no-op recorder) and reset span ids;
    returns the previously installed recorder."""
    global _RECORDER
    prev = _RECORDER
    _RECORDER = rec if rec is not None else NOOP
    _IDS.__init__()
    _tls.spans = []
    return prev


class recording:
    """Context manager: install a recorder for a scoped run.

        with obs.recording(obs.JsonlRecorder("events.jsonl")) as rec:
            ... serve ...
        # previous recorder restored, sink closed
    """

    def __init__(self, rec: Recorder):
        self.rec = rec
        self._prev: Optional[Recorder] = None

    def __enter__(self) -> Recorder:
        self._prev = set_recorder(self.rec)
        return self.rec

    def __exit__(self, *exc):
        set_recorder(self._prev)
        self.rec.close()
        return False


# ---------------------------------------------------------------------------
# spans and points
# ---------------------------------------------------------------------------

class _NullSpan:
    """The cached disabled-path context manager: zero allocation per use."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


# NVTX ranges exist only in a CUDA build of torch (a CPU build's
# torch.cuda.nvtx raises "NVTX functions not installed"): decided once here,
# not per span
_NVTX = torch.version.cuda is not None


class _Span:
    """One enabled span: times the region, threads parent/child ids, and
    names the region for torch.profiler (record_function) and NVTX."""

    __slots__ = ("rec", "name", "attrs", "id", "parent", "t0", "ts",
                 "_scope")

    def __init__(self, rec: Recorder, name: str, attrs: Dict[str, Any]):
        self.rec = rec
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else -1
        self.id = _IDS.take()
        st.append(self.id)
        self._scope = torch.profiler.record_function(self.name)
        self._scope.__enter__()
        if _NVTX:
            torch.cuda.nvtx.range_push(self.name)
        self.ts = time.time()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        dur = time.monotonic() - self.t0
        if _NVTX:
            torch.cuda.nvtx.range_pop()
        self._scope.__exit__(*exc)
        st = _stack()
        if st and st[-1] == self.id:
            st.pop()
        ev = dict(type="span", name=self.name, span=self.id,
                  parent=self.parent, ts=self.ts, dur_s=dur)
        if self.attrs:
            ev.update(self.attrs)
        self.rec.emit(ev)
        return False


def span(name: str, **attrs):
    """Context manager timing a named region. Near-free when no recorder
    is enabled (returns one cached null object). Keyword attrs land on the
    emitted event — keep them deterministic (see module docstring)."""
    rec = _RECORDER
    if not rec.enabled:
        return _NULL_SPAN
    return _Span(rec, name, attrs)


def point(name: str, **fields) -> None:
    """Emit one instantaneous structured event under the current span.
    No-op (one global load + attribute check) when disabled."""
    rec = _RECORDER
    if not rec.enabled:
        return
    st = _stack()
    parent = st[-1] if st else -1
    ev = dict(type="point", name=name, span=parent, parent=parent,
              ts=time.time())
    ev.update(fields)
    rec.emit(ev)
