"""One run of one cell: set-up, warm-up, the measured window, the traced
call, the check, and the result line.

The window is a closed loop: one caller sends each call when the last one
is back, cycling over the pool, until `seconds` have passed; the window
ends with the pass over the pool that is then running, so every seed's
window holds the same work, and its length is all the time of all the
work it completed. Every metric, end to end or per layer, is the
`read(run)` of its own file under `metrics/`.
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
import time

import torch

from harness import check, program, roofline, spec, trace, traffic
from harness.fleet import generator

SAMPLE_SALT = 0x5A3B1E      # the check's sample stream, apart from the draws
BANNED = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a run measured, as the metrics' readers see it."""
    dtype: str
    setup_s: float = 0.0              # process start to the window
    window_s: float = 0.0             # the measured window
    window_peak: int = 0              # bytes allocated at most in the window
    allocations: int = 0              # completed in the window
    host_reads: int = 0               # while_cells host reads in the window
    batched_iters: list = dataclasses.field(default_factory=list)
    sp2_evals: list = dataclasses.field(default_factory=list)
    trace: dict = None                # trace.reduce of the traced call
    traced_allocations: int = 0
    sp1_work: list = None             # (ops, bytes) of each sweep call


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(BANNED))


def spanned(name: str, fn, *args):
    with torch.profiler.record_function(trace.SPAN + name):
        return fn(*args)


def sp1_replay(wl, sys_) -> list:
    """Runs the call on `sys_` again untraced, counting each sweep call's
    work from its inputs (the solve is deterministic, so they are the
    traced call's inputs)."""
    from repro_torch.kernels import ops

    work, real = [], ops.sp1_lambda_sum

    def counting(T_grid, q, tt, consts):
        work.append(roofline.sp1_work(torch, T_grid, q, tt, consts))
        return real(T_grid, q, tt, consts)

    ops.sp1_lambda_sum = counting
    try:
        wl.call(sys_)
    finally:
        ops.sp1_lambda_sum = real
    return work


def run(workload: str, seed: int, seconds: float, traced: bool, t_start: float,
        device="cuda", call=None, cover_pool: bool = False, bench=None
        ) -> dict:
    """One run of `workload`. `call(wl)` gives the unit of work that
    replaces the program's (the control), and `cover_pool` makes the window
    call every fleet of the pool once at least; returns the result line's
    object."""
    bench = spec.benchmark() if bench is None else bench
    entry = spec.cell(bench, workload)
    cfg, mix = spec.config(entry["config"]), spec.traffic(entry["traffic"])
    limits = spec.limits(workload)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    wl = traffic.build(cfg, mix, seed, device)
    if call is not None:
        wl.call = call(wl)
    wl.call(wl.pool[0])              # warm-up: the shapes every call has
    sync()
    sample_gen = generator(int(seed) ^ SAMPLE_SALT, device)
    measured = Run(dtype=cfg["dtype"],
                   setup_s=time.perf_counter() - t_start)

    samples, stats, call_s = [], [], []
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reads0 = program.host_reads()
    calls, min_calls = 0, len(wl.pool) if cover_pool else 1
    t0 = time.perf_counter()
    while True:
        s = wl.pool[calls % len(wl.pool)]
        t_call = time.perf_counter()
        if traced and calls == 0:
            answer, measured.trace = trace.traced(
                lambda: spanned("solve", wl.call, s), sync, cuda)
        else:
            answer = wl.call(s)
        samples.append((s, check.take(answer, sample_gen, cfg)))
        stats.append(wl.kind.stats(answer))
        if traced and calls == 0:
            measured.traced_allocations = stats[-1].shape[-1]
        del answer
        sync()
        call_s.append(round(time.perf_counter() - t_call, 4))
        calls += 1
        if calls % len(wl.pool) == 0 and calls >= min_calls \
                and time.perf_counter() - t0 >= seconds:
            break
    measured.window_s = time.perf_counter() - t0
    measured.window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    memory_peak = max(setup_peak, measured.window_peak)
    measured.host_reads = program.host_reads() - reads0
    per_alloc = torch.cat(stats, -1).cpu()
    measured.allocations = per_alloc.shape[-1]
    measured.batched_iters = per_alloc[0].tolist()
    measured.sp2_evals = per_alloc[1].tolist()

    if traced and any("::sp1_" in k for k in measured.trace["kernels"]):
        measured.sp1_work = sp1_replay(wl, wl.pool[0])

    t_ref = time.perf_counter()
    sys_ref = check.reference_inputs(samples, device)
    prog = check.program_rows([s for _, s in samples])
    del samples
    ref = wl.kind.reference(sys_ref, cfg, mix, torch.float64)
    values = wl.kind.gaps(prog, ref, sys_ref, mix)
    correct, rows = check.judge(values, limits)
    print("info values " + json.dumps(values), file=sys.stderr, flush=True)
    print(f"info setup_s {measured.setup_s:.3f} window_s "
          f"{measured.window_s:.3f} calls {calls} reference_s "
          f"{time.perf_counter() - t_ref:.3f} sampled_cells "
          f"{sys_ref.gain.shape[0]} call_s {call_s}", file=sys.stderr,
          flush=True)

    metrics = {}
    for m in spec.metrics_of(bench, workload, traced):
        v = spec.reader(m["name"])(measured)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    banned = banned_modules()
    if banned:
        raise SystemExit(f"cardbench: the run loaded {banned}")
    result = {"correct": bool(correct), "attempted": measured.allocations,
              "failed": 0, "metrics": metrics,
              "device": device_record(device, memory_peak)}
    if traced:
        result["device"]["busy_s"] = measured.trace["busy_s"]
        result["device"]["window_s"] = measured.trace["window_s"]
        result["breakdown"] = measured.trace["breakdown"]
    result["checks"] = {k: {"value": number(v), "limit": lim}
                        for k, v, lim in rows}
    return result


def number(v: float):
    """A compared number as JSON holds it: a non-finite one as a string."""
    return v if math.isfinite(v) else str(v)


def device_record(device, memory_peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(memory_peak)}


def emit(result: dict) -> None:
    """The checks' lines on standard error, then the result's line last on
    standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
