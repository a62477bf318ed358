"""One unit of work under `torch.profiler`, reduced to what the per-layer
metrics read: the device's busy time (the union of its operations'
intervals), the traced window, the kernels by name, the device operations
that took the most time and the idle gaps by what the host was doing.

The device events are read off the profiler's raw kineto events, not
`key_averages()`, which costs ~60 us an event on the host (minutes for the
~10^5 launches of one fleet solve).
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Iterable, List, Tuple

SPAN = "cardbench."     # prefix of the benchmark's own record_function spans


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def union_length(intervals: Iterable[Tuple[int, int]]) -> Tuple[int, list]:
    """Total length of the union of [start, end) intervals, and the gaps
    between its pieces as (start, end) pairs, in time order."""
    total, gaps = 0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def innermost(host_ops: List[Tuple[int, int, str]], times: List[int]
              ) -> List[str]:
    """For each time (ascending), the name of the innermost host op whose
    [start, end] holds it ("python" where none does). Host ops of one
    thread nest, so the innermost is the latest-started one still open."""
    ops = sorted(host_ops)
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ops) and ops[i][0] <= t:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "python")
    return out


def reduce(device_events, host_ops, spans, window_ns: int, top: int = 10
           ) -> dict:
    """device_events: (name, start_ns, end_ns); host_ops: (start, end, name)
    of the host thread that drives the card; spans: the benchmark's own
    (start, end, name). Returns busy and window seconds, kernels by name
    {name: [calls, seconds]}, the top device ops and the idle gaps summed
    by the host's span and innermost op."""
    busy_ns, gaps = union_length((s, e) for _, s, e in device_events)
    kernels = defaultdict(lambda: [0, 0.0])
    for name, s, e in device_events:
        k = kernels[name]
        k[0] += 1
        k[1] += (e - s) / 1e9
    mids = [(a + b) // 2 for a, b in gaps]
    labels = innermost(host_ops, mids)
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    idle = defaultdict(float)
    for (a, b), mid, op in zip(gaps, mids, labels):
        j = bisect.bisect_right(starts, mid)
        holder = [n for s, e, n in spans[:j] if e >= mid]
        span = holder[0][len(SPAN):] if holder else "-"
        if op.startswith(SPAN):
            op = "python"
        idle[f"{span}/{op}"] += (b - a) / 1e9
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        busy_s=busy_ns / 1e9, window_s=window_ns / 1e9,
        kernels={n: list(v) for n, v in kernels.items()},
        launches=sum(v[0] for n, v in kernels.items() if is_kernel(n)),
        breakdown=dict(device_ops=[[n[:120], v[1]] for n, v in ops],
                       idle_gaps=[[n[:120], s] for n, s in gaps_top]))


def traced(fn, sync, cuda: bool = True):
    """fn() under the profiler, synchronised by `sync`; returns (fn's
    result, the `reduce` record of its window). `cuda` False traces the
    host alone (the CPU tests)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter_ns()
        out = fn()
        sync()
        window_ns = time.perf_counter_ns() - t0
    device, host, spans, threads = [], [], [], defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.device_type() == DeviceType.CPU:
            item = (e.start_ns(), e.end_ns(), e.name())
            if e.name().startswith(SPAN):
                spans.append(item)
            host.append((e.start_thread_id(), item))
            threads[e.start_thread_id()] += 1
    main = max(threads, key=threads.get) if threads else None
    host_ops = [item for tid, item in host if tid == main]
    return out, reduce(device, host_ops, spans, window_ns)
