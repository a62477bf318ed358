#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from `src/repro_torch/kernels/csrc`
(nvcc, into build/repro_torch/), then:

  1. prints the card, its power limit, the torch/CUDA versions and the
     build times (and ptxas's register/spill report);
  2. holds each kernel against its plain PyTorch version on the card, at
     the main path's shapes and at ragged ones, in float32 and float64,
     and checks that two launches on the same inputs agree bitwise;
  3. drives the main path through `repro_torch.solve` at full width — the
     C=64 x N=2048 float32 fleet, max_iters=8, weights (0.5, 0.5, 1.0),
     bandwidth 20 MHz per 50 devices — and the paper's single cell (N=50)
     in float64, with every kernel's launch count set to 0 just before and
     read just after; checks that every output is finite and feasible and
     that the kernel ran 3 times per batched BCD iteration;
  4. solves the paper cell and 4 cells of that fleet in float64 on the
     card and on the CPU (where the plain versions run) and compares them;
  5. times the warm fleet solve (median of 3) and each kernel per launch
     (CUDA events) beside its bound and its plain version;
  6. traces one fleet solve with torch.profiler: the card's busy time and
     idle share, and the kernels that take the most time.

Each phase prints a JSON record. The line before the last lists the
kernels; the last line is {"ok": true, "device": {...}}. Any failure exits
non-zero without that line, as does a machine without CUDA or a directory
without the rest of the checkout. Weights and systems come from fixed
seeds; nothing is downloaded.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Main-path shapes: the fleet acceptance shape of the JAX package
# (benchmarks/run.py fleet_scale).
FLEET_C, FLEET_N, FLEET_ITERS, FLEET_SEED = 64, 2048, 8, 31
PAPER_N, PAPER_SEED = 50, 0
WEIGHTS = (0.5, 0.5, 1.0)

# Published H100 SXM peaks (NVIDIA data sheet, dense, no sparsity): HBM3
# bandwidth, and the FP32 / FP64 rates outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "float64": 34e12}

# Floating-point operations of one lambda_n(T) evaluation in
# lambda_of_T_linear, counting each add, multiply, divide, compare/select,
# sqrt, cbrt and pow as one: 6 shared (t_c, q_safe, alpha, k3_safe),
# 2 x 12 f-clipped and 2 x 6 s-clipped candidates, 11 for the interior one,
# 6 x 23 for the clip-and-validate of each candidate, 19 for the best /
# near-tie pick, 6 for the unattainable-deadline test, and 1 for the sum.
SP1_OPS_PER_PAIR = 6 + 24 + 12 + 11 + 138 + 19 + 6 + 1

TOL_F64 = 1e-10   # relative (a zero sum must come out exactly zero)
TOL_F32 = 1e-4    # relative to max(|sum|, 1e-6 * lam_hi * N)


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def record(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def main():
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        raise SmokeError(f"no src/repro_torch beside {Path(__file__).name}: "
                         "run it from the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    built = build.build()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in build.log_path(name).read_text()
                    .splitlines() if "registers" in ln or "spill" in ln]
             for name in build.sources()}
    record("env", card=smi, device=torch.cuda.get_device_name(0),
           count=torch.cuda.device_count(), torch=torch.__version__,
           cuda=torch.version.cuda, python=sys.version.split()[0],
           build_s=build_s, built=built, ptxas=ptxas)

    kernels = [phase_sp1_kernel(torch)]
    fleet_run = phase_main_path(torch)
    kernels[0]["launches"] = fleet_run["launches"]["sp1_lambda_sum"]
    phase_card_vs_cpu(torch)
    phase_times(torch, kernels)
    phase_profile(torch)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def fleet_system(torch, dtype, n_cells=None, n_devices=None):
    from repro_torch import make_fleet

    n_cells = FLEET_C if n_cells is None else n_cells
    n_devices = FLEET_N if n_devices is None else n_devices
    return make_fleet(FLEET_SEED, n_cells, n_devices, device="cuda",
                      dtype=dtype, bandwidth_total=20e6 * n_devices / 50)


def sweep_inputs(torch, sysp, weights=WEIGHTS):
    """The SP1 sweep's first-round kernel inputs for `sysp` at its initial
    allocation, ((T_grid (C, 16), q / tt (C, N), consts (C, 8)), target
    (C, 1)), and the number of devices per cell whose makespan floor lies
    within 16 ulps of the grid's first point T_lo (C,)."""
    from repro_torch.api.problem import weights_leaf
    from repro_torch.core.accuracy import default_accuracy
    from repro_torch.core.bcd import initial_allocation
    from repro_torch.core.energy import rate
    from repro_torch.core.sp1 import (_SWEEP_POINTS, _coeffs, _geomspace,
                                      _sp1_bounds, _sweep_consts)
    from repro_torch.core.types import Weights

    b = sysp.batched()
    alloc = initial_allocation(b)
    tt = b.bits / torch.clamp_min(rate(b, alloc.bandwidth, alloc.power),
                                  1e-12)
    warr = weights_leaf(Weights(*weights), b.dtype, b.device,
                        cells=b.gain.shape[0])
    w = Weights(warr[:, 0:1], torch.clamp_min(warr[:, 1:2], 1e-9),
                warr[:, 2:3])
    _, q = _coeffs(b, w)
    lam_hi, target, T_lo, T_hi = _sp1_bounds(b, w, q, tt)
    consts = _sweep_consts(b, w, default_accuracy(), lam_hi)
    grid = _geomspace(T_lo, T_hi, _SWEEP_POINTS).contiguous()
    floor = q * b.s_lo ** 2 / b.f_max + tt
    n_edge = (floor >= grid[:, :1] * (1 - 16 * torch.finfo(b.dtype).eps)
              ).sum(-1)
    return (grid, q.contiguous(), tt.contiguous(), consts), target, n_edge


def bracket_index(torch, S, target):
    """The sweep's bracket pick from the sums S (C, M), as in
    `core/sp1.py::_solve_sp1_sweep_impl`."""
    n = S.shape[-1]
    index = torch.arange(n, device=S.device)
    first = torch.where(S < target, index, n).amin(-1, keepdim=True)
    return torch.where(first == n, n - 1, torch.clamp_min(first, 1))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_sp1_kernel(torch):
    """sp1_lambda_sum against its plain version on the card."""
    from repro_torch import make_system
    from repro_torch.kernels import sp1_sweep

    inputs = [(dtype, fleet_system(torch, dtype, FLEET_C if n == FLEET_N
                                   else 4, n), weights, n == FLEET_N)
              for dtype in (torch.float32, torch.float64)
              for n, weights in ((FLEET_N, WEIGHTS), (5, WEIGHTS),
                                 (1500, WEIGHTS), (1500, (0.0, 1.0, 1.0)))]
    # the single-cell path's shape: the paper cell (C=1, N=50, float64)
    inputs.append((torch.float64, make_system(
        PAPER_SEED, n_devices=PAPER_N, device="cuda", dtype=torch.float64),
        WEIGHTS, True))
    main_abs_err = 0.0
    cases = []
    for dtype, sysp, weights, on_main_path in inputs:
        tol = TOL_F32 if dtype == torch.float32 else TOL_F64
        args, target, n_edge = sweep_inputs(torch, sysp, weights)
        c, n = args[1].shape
        out = sp1_sweep.sp1_lambda_sum(*args)
        again = sp1_sweep.sp1_lambda_sum(*args)
        plain = sp1_sweep.sp1_lambda_sum_ref(*args)
        torch.cuda.synchronize()
        where = f"C={c}, N={n}, w1={weights[0]}, {dtype}"
        check(bool(torch.isfinite(out).all()),
              f"sp1_lambda_sum: non-finite sums ({where})")
        check(torch.equal(out, again),
              f"sp1_lambda_sum: two launches differ ({where})")
        lam_hi = args[3][:, 6:7]
        floor = 1e-6 * lam_hi * n if dtype == torch.float32 \
            else torch.full_like(plain, torch.finfo(dtype).tiny)
        scale = torch.maximum(plain.abs(), floor)
        err = (out - plain).abs()
        # The first grid point is T_lo = max makespan floor * (1 + 1e-12),
        # and 1 + 1e-12 rounds to 1 in float32: a device whose floor lies
        # within ulps of T_lo sits on its attainability edge, where every
        # lambda from its corner value up to lam_hi ties in makespan and
        # rounding picks one. There the two versions may differ by up to
        # lam_hi per such device (n_edge, counted from the inputs: 1 per
        # cell in float32, 0 in float64); every other grid point is held
        # to the tolerance, and the bracket pick must agree.
        edge = n_edge.to(dtype)[:, None] * lam_hi
        cols = slice(1, None) if bool((n_edge > 0).any()) else slice(None)
        rel = float((err / scale)[:, cols].max())
        abs_err = float(err[:, cols].max())
        edge_err = float((err[:, :1] - edge).max())
        same_bracket = torch.equal(bracket_index(torch, out, target),
                                   bracket_index(torch, plain, target))
        if on_main_path:
            main_abs_err = max(main_abs_err, abs_err)
        cases.append(dict(dtype=str(dtype).removeprefix("torch."),
                          C=c, M=args[0].shape[1], N=n, w1=weights[0],
                          max_rel_err=rel, max_abs_err=abs_err, tol=tol,
                          n_edge=int(n_edge.max()),
                          edge_abs_err=float(err[:, 0].max()),
                          edge_excess_over_tie=edge_err,
                          same_bracket=same_bracket))
        check(rel <= tol, f"sp1_lambda_sum: kernel vs plain rel err "
                          f"{rel:.3g} > {tol:g} ({where})")
        check(bool((err[:, :1] <= edge + tol * scale[:, :1]).all()),
              f"sp1_lambda_sum: at T_lo kernel and plain differ by "
              f"{edge_err:.3g} beyond {int(n_edge.max())} tied device(s) "
              f"({where})")
        check(same_bracket, f"sp1_lambda_sum: kernel and plain sums pick "
                            f"different brackets ({where})")
    record("kernel_vs_plain", kernel="sp1_lambda_sum", cases=cases)
    return dict(name="sp1_lambda_sum", route="cuda",
                source="src/repro_torch/kernels/csrc/sp1_sweep.cu",
                replaces="src/repro/kernels/sp1_sweep.py:121",
                launches=None, max_abs_err=main_abs_err)


def feasible_cells(torch, sysp, alloc):
    """Per-cell feasibility of a (C, N) allocation, sums in float64."""
    b = sysp.batched()
    C = b.gain.shape[0]
    B, p, f, s = (x.reshape(C, -1).double()
                  for x in (alloc.bandwidth, alloc.power, alloc.freq,
                            alloc.resolution))
    menu = torch.as_tensor(b.resolutions, dtype=torch.float64,
                           device=B.device)
    checks = {
        "finite": all(bool(torch.isfinite(x).all()) for x in (B, p, f, s)),
        "bandwidth": bool((B >= 0).all() and (B.sum(-1, keepdim=True)
                          <= b.bandwidth_total.double() * (1 + 1e-6)).all()),
        "power": bool(((p >= b.p_min.double() * (1 - 1e-6))
                       & (p <= b.p_max.double() * (1 + 1e-6))).all()),
        "freq": bool(((f >= b.f_min.double() * (1 - 1e-6))
                      & (f <= b.f_max.double() * (1 + 1e-6))).all()),
        "resolution": bool(((s[..., None] - menu).abs().amin(-1)
                            < 1e-3).all()),
    }
    return checks


def counted_solve(torch, problem, spec):
    """solve() with every kernel count and the host-read count set to 0
    just before and read just after."""
    from repro_torch import solve
    from repro_torch.core.loops import while_cells
    from repro_torch.kernels import sp1_sweep

    sp1_sweep.sp1_lambda_sum.launches = 0
    while_cells.host_reads = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(problem, spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"sp1_lambda_sum": sp1_sweep.sp1_lambda_sum.launches}
    return res, counts, while_cells.host_reads, wall


def phase_main_path(torch):
    from repro_torch import Problem, SolverSpec, Weights, make_system

    fleet = fleet_system(torch, torch.float32)
    spec = SolverSpec(max_iters=FLEET_ITERS)
    res, counts, reads, wall = counted_solve(
        torch, Problem(system=fleet, weights=Weights(*WEIGHTS)), spec)
    iters = res.iters.cpu()
    batched_iters = int(iters.max())
    feas = feasible_cells(torch, fleet, res.allocation)
    obj = res.objective.double()
    run = dict(topology="fleet", C=FLEET_C, N=FLEET_N, dtype="float32",
               max_iters=FLEET_ITERS, first_call_s=wall,
               converged=int(res.converged.sum()), cells=FLEET_C,
               iters=iters.tolist(), batched_iters=batched_iters,
               mean_objective=float(obj.mean()),
               objective_finite=bool(torch.isfinite(obj).all()),
               feasible=feas, launches=counts, host_reads=reads,
               sp2_evals=res.counters.sp2_evals.double().mean().item())
    record("main_path", **run)
    check(run["objective_finite"] and all(feas.values()),
          f"fleet: infeasible or non-finite result {feas}")
    check(counts["sp1_lambda_sum"] > 0, "fleet: sp1_lambda_sum never ran")
    check(counts["sp1_lambda_sum"] == 3 * batched_iters,
          f"fleet: {counts['sp1_lambda_sum']} launches for "
          f"{batched_iters} batched BCD iterations (want 3 each)")

    cell = make_system(PAPER_SEED, n_devices=PAPER_N, device="cuda",
                       dtype=torch.float64)
    res1, counts1, reads1, wall1 = counted_solve(
        torch, Problem(system=cell, weights=Weights(*WEIGHTS)), SolverSpec())
    feas1 = feasible_cells(torch, cell, res1.allocation)
    record("main_path", topology="single", N=PAPER_N, dtype="float64",
           first_call_s=wall1, iters=res1.iters, converged=res1.converged,
           objective=res1.objective, feasible=feas1, launches=counts1,
           host_reads=reads1, counters=res1.counters.as_dict())
    check(math.isfinite(res1.objective) and all(feas1.values()),
          f"single cell: infeasible or non-finite result {feas1}")
    check(counts1["sp1_lambda_sum"] == 3 * res1.iters,
          f"single cell: {counts1['sp1_lambda_sum']} launches for "
          f"{res1.iters} BCD iterations")
    return dict(launches=counts, host_reads=reads)


def phase_card_vs_cpu(torch):
    """Four fleet cells and the paper cell in float64, solved on the card
    and on the CPU."""
    from repro_torch import (Problem, SolverSpec, Weights, make_system, solve,
                             stack_systems)

    cell = make_system(PAPER_SEED, n_devices=PAPER_N, device="cuda",
                       dtype=torch.float64)
    weights = Weights(*WEIGHTS)
    gpu1 = solve(Problem(system=cell, weights=weights), SolverSpec())
    cpu1 = solve(Problem(system=cell.to("cpu"), weights=weights),
                 SolverSpec())
    rel1 = abs(gpu1.objective - cpu1.objective) / abs(cpu1.objective)
    record("card_vs_cpu", topology="single", N=PAPER_N, dtype="float64",
           objective_card=gpu1.objective, objective_cpu=cpu1.objective,
           rel_diff=rel1, iters_card=gpu1.iters, iters_cpu=cpu1.iters)
    check(rel1 <= 1e-8,
          f"card vs CPU, paper cell: objective rel diff {rel1:.3g} > 1e-8")
    check(gpu1.iters == cpu1.iters,
          "card vs CPU, paper cell: BCD iteration counts differ")

    fleet = fleet_system(torch, torch.float64)
    four = stack_systems([fleet.cell(c) for c in range(4)])
    spec = SolverSpec(max_iters=FLEET_ITERS)
    gpu = solve(Problem(system=four, weights=weights), spec)
    t0 = time.perf_counter()
    cpu = solve(Problem(system=four.to("cpu"), weights=weights), spec)
    cpu_s = time.perf_counter() - t0
    og, oc = gpu.objective.cpu(), cpu.objective
    rel = float(((og - oc).abs() / oc.abs()).max())
    record("card_vs_cpu", C=4, N=FLEET_N, dtype="float64",
           objective_card=og.tolist(), objective_cpu=oc.tolist(),
           max_rel_diff=rel, iters_card=gpu.iters.tolist(),
           iters_cpu=cpu.iters.tolist(), cpu_solve_s=cpu_s)
    check(rel <= 1e-8, f"card vs CPU: objective rel diff {rel:.3g} > 1e-8")
    check(torch.equal(gpu.iters.cpu(), cpu.iters),
          "card vs CPU: BCD iteration counts differ")


def event_ms(torch, fn, reps):
    """Mean milliseconds per call of `fn` over `reps` calls (CUDA events),
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_times(torch, kernels):
    from repro_torch import Problem, SolverSpec, Weights
    from repro_torch.kernels import sp1_sweep

    fleet = fleet_system(torch, torch.float32)
    problem = Problem(system=fleet, weights=Weights(*WEIGHTS))
    spec = SolverSpec(max_iters=FLEET_ITERS)
    walls = []
    for _ in range(3):
        _, counts, reads, wall = counted_solve(torch, problem, spec)
        walls.append(wall)
    record("fleet_solve", C=FLEET_C, N=FLEET_N, dtype="float32",
           max_iters=FLEET_ITERS, walls_s=walls,
           median_s=statistics.median(walls), host_reads=reads,
           launches=counts)

    args, _, _ = sweep_inputs(torch, fleet)
    C, M = args[0].shape
    N = args[1].shape[1]
    launches = sp1_sweep.sp1_lambda_sum.launches
    ms = event_ms(torch, lambda: sp1_sweep.sp1_lambda_sum(*args), 200)
    sp1_sweep.sp1_lambda_sum.launches = launches   # timing runs do not count
    plain_ms = event_ms(torch, lambda: sp1_sweep.sp1_lambda_sum_ref(*args), 10)
    itemsize = args[0].element_size()
    moved = itemsize * (C * M + 2 * C * N + C * 8 + C * M)
    ops = SP1_OPS_PER_PAIR * C * M * N
    bytes_ms = moved / PEAK_BYTES_S * 1e3
    ops_ms = ops / PEAK_OPS_S["float32"] * 1e3
    k = kernels[0]
    k.update(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
             bound_by="operations" if ops_ms >= bytes_ms else "bytes",
             library_ms=None)
    record("kernel_times", kernel="sp1_lambda_sum", C=C, M=M, N=N,
           dtype="float32", ms=ms, plain_ms=plain_ms, bytes=moved, ops=ops,
           bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms)


def phase_profile(torch):
    """One fleet solve under torch.profiler: the card's busy time (sum of
    kernel self times; one stream, so kernels do not overlap), its idle
    share of the traced wall time, the kernel launches and the kernels
    that take the most time. Tracing slows the host, so the traced wall
    time is longer than the untraced one of `fleet_solve`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import Problem, SolverSpec, Weights

    problem = Problem(system=fleet_system(torch, torch.float32),
                      weights=Weights(*WEIGHTS))
    spec = SolverSpec(max_iters=FLEET_ITERS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, reads, wall = counted_solve(torch, problem, spec)
    gpu = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in gpu) / 1e3
    top = sorted(gpu, key=lambda e: -e.self_device_time_total)[:6]
    record("profile", C=FLEET_C, N=FLEET_N, dtype="float32",
           traced_wall_s=wall, device_busy_ms=busy_ms,
           device_idle_share=(1.0 - busy_ms / (wall * 1e3)) if busy_ms
           else None, kernel_launches=sum(e.count for e in gpu),
           host_reads=reads,
           top_kernels=[dict(name=e.key[:80], calls=e.count,
                             device_ms=e.self_device_time_total / 1e3)
                        for e in top])


if __name__ == "__main__":
    try:
        main()
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
