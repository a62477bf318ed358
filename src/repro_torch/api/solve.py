"""`solve(problem, spec)` — the one entry point to Algorithm 2.

Port of `repro/api/solve.py` for these topologies:

    single cell        -> BCD (`BCDResult`)
    (C, N) stack       -> the same BCD on every cell at once (`FleetResult`)
    + deadline         -> deadline-constrained BCD (`BCDResult`; on a
                          (C, N) stack every cell at once, with a scalar or
                          a (C,) per-cell deadline -> `FleetResult`)
    + rounds config    -> the round-dynamics engine (`RoundsResult`, one
                          cell or every cell of a stack at once)
    + mesh             -> the stack's cell axis split over a
                          `region.RegionMesh` (`RegionResult` for the free
                          and deadline solves, `RoundsResult` for rounds):
                          shard-local exits, or one lockstep batch with
                          `SolverSpec.lockstep`

Every engine of `SolverSpec` runs on each of them (SP1 "sweep"/"bisect",
SP2 "direct"/"jong"). The solve runs on the device the system's tensors
live on (a mesh solve on the mesh's devices). `Problem.assoc` raises
NotImplementedError naming the ROADMAP item that ports it.

When a `repro_torch.obs` recorder is enabled the whole call is wrapped in
a `solve` span tagged with the routed topology (`_topology_label`); with
the default no-op recorder this is one predicate check.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.accuracy import default_accuracy
from ..core.bcd import (_FIXED_COLS, _LEDGER_COLS, BCDResult, SolveCounters,
                        _allocate_fixed_impl, _allocate_impl, _fleet_result,
                        _init_carry_state, _materialize_history,
                        initial_allocation)
from ..core.types import Allocation, SystemParams
from ..dynamics.config import RoundsResult
from ..dynamics.engine import (check_simulation_init, round_draws,
                               rounds_result, run_engine)
from .problem import Problem, weights_leaf
from .spec import SolverSpec, warn_tol_floor

# Problem fields of topologies not ported yet -> the ROADMAP item porting them
_LATER = {
    "assoc": "Queue 1 item 10 (association)",
}


def _apply_dtype(system: SystemParams, init: Optional[Allocation],
                 dtype: Optional[str]):
    if dtype is None:
        return system, init
    dt = getattr(torch, dtype)
    return (system.to(dtype=dt),
            None if init is None else init.to(dtype=dt))


def _topology_label(problem: Problem) -> str:
    """Deterministic topology tag for the solve span (shape metadata only —
    reading `.ndim` never waits on the device)."""
    if problem.assoc is not None:
        return "assoc"
    base = ("rounds" if problem.rounds is not None
            else "fixed" if problem.deadline is not None else "bcd")
    if problem.mesh is not None:
        return base + "_region"
    if problem.system.gain.ndim == 2:
        return base + "_fleet"
    return base


def solve(problem: Problem, spec: Optional[SolverSpec] = None):
    """Solve one `Problem` under one `SolverSpec`; route on topology.

    Returns a `BCDResult` for a single cell and a `FleetResult` for a
    (C, N) stack, with the same fields, iteration counts, ledger columns
    and counters as `repro.solve`; a `RegionResult` for a stack over a
    mesh; a `RoundsResult` for a rounds problem.
    """
    from .. import obs

    if not obs.enabled():
        return _solve_routed(problem, spec)
    with obs.span("solve", topology=_topology_label(problem)):
        return _solve_routed(problem, spec)


def _solve_routed(problem: Problem, spec: Optional[SolverSpec]):
    spec = SolverSpec() if spec is None else spec
    for field, item in _LATER.items():
        if getattr(problem, field) is not None:
            raise NotImplementedError(
                f"repro_torch.solve: Problem.{field} is not ported yet; see "
                f"ROADMAP.md {item}")
    if spec.lockstep and problem.mesh is None:
        # lockstep selects the execution mode of a mesh solve; on a
        # meshless problem it would silently do nothing
        raise ValueError("solve: SolverSpec.lockstep requires Problem.mesh")
    cells = problem.cells   # also validates system.gain is 1-D or 2-D
    if problem.mesh is not None and cells is None:
        raise ValueError("solve: mesh requires a stacked (C, N) system "
                         "(stack_systems / make_fleet)")
    sysp, init = _apply_dtype(problem.system, problem.init, spec.dtype)
    acc = problem.acc if problem.acc is not None else default_accuracy()
    if problem.rounds is not None:
        return _solve_rounds(problem, spec, sysp, init, acc)
    warn_tol_floor(spec.tol, sysp.dtype)
    alloc0 = init if init is not None else initial_allocation(
        sysp, bandwidth_frac=problem.bandwidth_frac
        if problem.deadline is not None else 1.0)
    batch = sysp.batched()
    state0 = _init_carry_state(batch, alloc0)
    warr = weights_leaf(problem.weights, sysp.dtype, sysp.device,
                        cells=1 if cells is None else cells)
    if problem.deadline is None:
        def fn(b, w, st):
            return _allocate_impl(b, w, acc, st, spec.max_iters, spec.tol,
                                  spec.sp1_method, spec.sp2_method,
                                  spec.sp2_iters)
        args, cols = (batch, warr, state0), _LEDGER_COLS
    else:
        def fn(b, w, st, T_round):
            return _allocate_fixed_impl(b, w, acc, T_round, st,
                                        spec.max_iters, spec.tol,
                                        spec.sp2_method, spec.sp2_iters)
        args = (batch, warr, state0, _per_cell_T_round(problem, batch, cells))
        cols = _FIXED_COLS
    if problem.mesh is not None:
        return _solve_region(problem.mesh, spec, fn, args, cells, cols)
    out = fn(*args)
    if cells is None:
        return _bcd_result(out, alloc0, spec, cols)
    return _fleet_result(out, spec.max_iters, cols)


def _solve_region(mesh, spec: SolverSpec, fn, args, cells: int, cols):
    """A (free or deadline) fleet solve over `mesh`, shard by shard (or in
    one lockstep batch). Per-cell results are bit-identical to the
    unsharded fleet solve (`region.mesh`). Returns a `RegionResult`."""
    from ..region.mesh import RegionResult, _pack_stats, run_over_mesh

    fleet = _fleet_result(run_over_mesh(fn, args, cells, mesh,
                                        spec.lockstep),
                          spec.max_iters, cols)
    return RegionResult(fleet=fleet,
                        _stats_packed=_pack_stats(fleet, n_shards=mesh.size),
                        _n_cells=cells, _mesh_devices=mesh.size)


def _solve_rounds(problem: Problem, spec: SolverSpec, sysp: SystemParams,
                  init: Optional[Allocation], acc) -> RoundsResult:
    """R rounds of the round-dynamics engine on every cell at once; the
    reference's rounds / deadline / key / SolverSpec errors."""
    if problem.deadline is not None:
        raise ValueError("solve: rounds and deadline are exclusive")
    if problem.key is None:
        raise ValueError(
            "solve: a rounds problem needs problem.key (its draws, a "
            "torch.Generator or a seed for the channel / participation "
            "sampling)")
    # the per-round solver options live on RoundsConfig; silently dropping
    # a tuned spec would mislead, so only the fields the rounds paths
    # consult (lockstep, dtype) may differ from the defaults
    if spec != SolverSpec(lockstep=spec.lockstep, dtype=spec.dtype):
        raise ValueError(
            "solve: a rounds problem takes its BCD options "
            "(bcd_iters/bcd_tol/sp*_method) from the RoundsConfig, not "
            "from SolverSpec — configure problem.rounds instead (only "
            "SolverSpec.lockstep and .dtype apply here)")
    cfg = problem.rounds
    check_simulation_init(cfg, init)
    batch = sysp.batched()
    alloc0 = init if init is not None else initial_allocation(sysp)
    state0 = _init_carry_state(batch, alloc0)
    cells = problem.cells
    warr = weights_leaf(problem.weights, sysp.dtype, sysp.device,
                        cells=1 if cells is None else cells)
    draws = round_draws(problem.key, batch, cfg)

    def fn(b, w, d, st):
        return run_engine(b, w, acc, d, st, cfg)

    args = (batch, warr, draws, state0)
    if problem.mesh is None:
        return rounds_result(fn(*args), single=cells is None)
    from ..region.mesh import run_over_mesh

    return rounds_result(run_over_mesh(fn, args, cells, problem.mesh,
                                       spec.lockstep), single=False)


def _per_cell_T_round(problem: Problem, batch: SystemParams,
                      cells: Optional[int]) -> torch.Tensor:
    """The per-round deadline of every cell, (C, 1): Problem.deadline (a
    total budget over all rounds: a scalar, or a (C,) array on a stack)
    over each cell's global_rounds."""
    deadline = torch.as_tensor(problem.deadline, dtype=batch.dtype,
                               device=batch.device)
    C = batch.gain.shape[0]
    if deadline.ndim > (0 if cells is None else 1) \
            or (deadline.ndim == 1 and deadline.shape[0] != C):
        want = "a scalar" if cells is None \
            else f"a scalar or a ({C},) per-cell array"
        raise ValueError(f"solve: deadline must be {want}, got shape "
                         f"{tuple(deadline.shape)}")
    return torch.broadcast_to(deadline.reshape(-1, 1), (C, 1)) \
        / batch.global_rounds


def _bcd_result(out, alloc0: Allocation, spec: SolverSpec, cols
                ) -> BCDResult:
    """Single-cell result: the ledger materialized (or, with
    keep_history=False, only the objective), and the untouched init when
    max_iters=0 ran nothing (objective NaN). Ledger column 0 is the
    objective ("objective", or the deadline variant's "energy", which has
    no s_relaxed)."""
    B, pw, f, s, s_hat, T, iters, conv, ledger, counters = out
    iters = int(iters[0])
    if spec.keep_history:
        history = _materialize_history(ledger[0].cpu().numpy(), iters, cols)
        objective = history[-1][cols[0]] if history else float("nan")
    else:
        history = []
        objective = float(ledger[0, iters - 1, 0]) if iters else float("nan")
    allocation = Allocation(
        bandwidth=B[0], power=pw[0], freq=f[0], resolution=s[0],
        s_relaxed=s_hat[0] if cols is _LEDGER_COLS else None,
        T=T[0, 0]) if iters else alloc0
    return BCDResult(allocation=allocation, objective=objective,
                     history=history, iters=iters, converged=bool(conv[0]),
                     counters=SolveCounters(data=counters[0]))
