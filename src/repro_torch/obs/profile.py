"""Profiling plane: torch.profiler trace sessions + counted-FLOP gauges.

Port of `repro/obs/profile.py`. Two tools, both opt-in (nothing here runs
on the serving path):

  * `trace(logdir, label=...)` — a context manager around a
    `torch.profiler.profile` session (CPU activity, and CUDA activity
    where CUDA is available), exported on exit as a Chrome / perfetto
    trace `<logdir>/<label>.trace.json`. The session is wrapped in an
    `obs.span("profile", label=...)`, so work done inside shows up under
    the enclosing span names (`recorder._Span` enters
    `torch.profiler.record_function` per span). One session at a time —
    a nested `trace` is a no-op yielding ``None``. The session's wall
    time lands in the `profiler_trace_seconds{label=...}` gauge and each
    completed session bumps `profiler_traces`.

  * `record_cost(label, fn, *args, ...)` — RUN `fn(*args)` once under
    `torch.utils.flop_counter.FlopCounterMode` and record the counted
    FLOPs as the `xla_cost_flops{shape=label}` gauge (and 0.0 as
    `xla_cost_bytes{shape=label}`). The gauge names are the reference's,
    so a dashboard reads both packages alike. Unlike the reference, which
    lowers and compiles without executing, this executes the function.

What the counter sees: FlopCounterMode counts the operators it has a
formula for (matrix products, convolutions, attention). Elementwise work
counts 0, and so does anything launched outside the operator dispatcher,
such as the port's ctypes-bound CUDA kernels (`sp1_lambda_sum` and the
rest). The mode counts no bytes, so `bytes_accessed` is always 0.0.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional

import torch

from . import recorder as _rec
from .metrics import MetricsRegistry, REGISTRY

__all__ = ["trace", "record_cost", "solve_cost"]

_TRACE_LOCK = threading.Lock()
_TRACE_ACTIVE = False


@contextlib.contextmanager
def trace(logdir: str, label: str = "trace",
          registry: Optional[MetricsRegistry] = None):
    """Profile the enclosed block with torch.profiler and export the
    Chrome trace into `logdir`. Yields the logdir, or ``None`` when a
    session is already active (nested use degrades to a pass-through)."""
    global _TRACE_ACTIVE
    from torch.profiler import ProfilerActivity, profile

    with _TRACE_LOCK:
        if _TRACE_ACTIVE:
            nested = True
        else:
            _TRACE_ACTIVE = True
            nested = False
    if nested:
        yield None
        return
    reg = registry if registry is not None else REGISTRY
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        with _rec.span("profile", label=label):
            os.makedirs(logdir, exist_ok=True)
            prof = profile(activities=activities)
            prof.__enter__()
            t0 = time.monotonic()
            try:
                yield logdir
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                dur = time.monotonic() - t0
                prof.export_chrome_trace(
                    os.path.join(logdir, f"{label}.trace.json"))
                reg.gauge("profiler_trace_seconds", label=label).set(dur)
                reg.counter("profiler_traces").inc()
    finally:
        with _TRACE_LOCK:
            _TRACE_ACTIVE = False


def record_cost(label: str, fn, *args,
                registry: Optional[MetricsRegistry] = None,
                **kwargs) -> Dict[str, float]:
    """Run `fn(*args, **kwargs)` once under FlopCounterMode and record its
    counted FLOPs. Returns ``{"flops", "bytes_accessed"}``; the bytes are
    always 0.0 (the mode counts none). Executes `fn`: call it from a
    measurement script, never from the serving path."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    flops = float(counter.get_total_flops())
    reg = registry if registry is not None else REGISTRY
    reg.gauge("xla_cost_flops", shape=label).set(flops)
    reg.gauge("xla_cost_bytes", shape=label).set(0.0)
    return dict(flops=flops, bytes_accessed=0.0)


def solve_cost(problem, spec=None,
               registry: Optional[MetricsRegistry] = None
               ) -> Dict[str, float]:
    """`record_cost` of `solve(problem, spec)`, keyed
    ``solve.bcd.N<devices>`` (one cell) or ``solve.fleet.C<cells>.N<devices>``
    (an unsharded (C, N) fleet); other topologies raise ValueError —
    profile those with `trace`.

    This RUNS the solve once (the reference's only lowers it). The BCD is
    elementwise work and ctypes-launched kernels, which FlopCounterMode
    does not count, so a solve's count is small or 0."""
    from ..api.solve import _topology_label, solve

    topo = _topology_label(problem)
    if topo not in ("bcd", "bcd_fleet"):
        raise ValueError(
            f"solve_cost: only single-cell and fleet topologies are "
            f"supported, got {topo!r}")
    gain = problem.system.gain
    label = f"solve.bcd.N{gain.shape[0]}" if topo == "bcd" \
        else f"solve.fleet.C{gain.shape[0]}.N{gain.shape[1]}"
    return record_cost(label, solve, problem, spec, registry=registry)
