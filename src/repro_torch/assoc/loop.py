"""BCD-over-association: the cross-cell user association outer loop.

Port of `repro/assoc/loop.py`. The paper fixes each device to one base
station; its multi-cell follow-ups (arXiv:2212.08324, arXiv:2301.12085)
let devices pick a serving cell. This module layers that choice over the
per-cell `solve()`:

  1. *association step*: each device greedily picks the cell minimizing
     its marginal weighted cost given the current allocations, under
     per-cell capacity caps (`AssocConfig.capacity`);
  2. *resource step*: the per-cell resources are re-solved for the new
     association through the one `solve()` dispatcher, every cell in one
     batch (3 `sp1_lambda_sum` launches per batched BCD iteration).

A cross-cell problem is a stacked (C, N) `SystemParams` whose row c holds
every device's gain *to cell c*; an association is an (N,) int array.
Cell c's solvable view is the full N-device row with ``active[c, n] =
(assign[n] == c)`` (`SystemParams.with_assignment`), so every association
the loop visits solves at one (C, N) shape.

A proposed reassignment is accepted only if the realized global objective
(sum of per-cell weighted objectives) strictly improves, so the accepted
objective sequence is decreasing and the loop stops at a fixed point.

The outer-loop bookkeeping (cost matrices, greedy assignment) is host
float64 numpy with stable sorts, as in the reference: bit-deterministic.
The system's fields cross to the host once per call, and each outer step
makes one packed host copy: the re-solved cells' objectives together with
their resolutions, which the next step's marginal costs read.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..core import energy as en
from ..core.accuracy import AccuracyModel, default_accuracy
from ..core.bcd import initial_allocation
from ..core.types import Allocation, SystemParams
from .config import AssocConfig, AssocResult

Tensor = torch.Tensor

_TINY_RATE = 1e-12   # same guards as core.energy.t_trans / t_cmp
_TINY_FREQ = 1e-9
_TINY_BAND = 1e-9

# the system fields the marginal costs read, (C, N) then (C, 1)
_COST_ARRAYS = ("gain", "cycles", "samples", "bits")
_COST_SCALARS = ("bandwidth_total", "p_max", "noise_psd", "s_standard",
                 "local_iters", "f_max", "kappa", "global_rounds")


def _to_host(tensors: Sequence[Tensor]) -> list:
    """float64 numpy copies of `tensors` through ONE device-to-host copy
    (concatenated flat on the device, split on the host)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    flat = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


@dataclasses.dataclass(frozen=True)
class _HostCells:
    """The fields `marginal_costs` reads, on the host in float64: (C, N)
    device arrays and (C, 1) per-cell scalars, and the (N,) base mask."""
    fields: dict
    active: np.ndarray


def _host_cells(sysb: SystemParams) -> _HostCells:
    C, N = sysb.gain.shape
    names = _COST_ARRAYS + _COST_SCALARS
    leaves = [torch.broadcast_to(getattr(sysb, k), (C, N) if
                                 k in _COST_ARRAYS else (C, 1))
              for k in names]
    return _HostCells(fields=dict(zip(names, _to_host(leaves))),
                      active=_base_active(sysb))


def _base_active(sysb: SystemParams) -> np.ndarray:
    """(N,) bool: devices that exist at all. A stacked base mask marks a
    device inactive only if NO cell could serve it (all-False column)."""
    N = sysb.gain.shape[1]
    if sysb.active is None:
        return np.ones(N, dtype=bool)
    return sysb.active.any(0).cpu().numpy()


def _costs(hc: _HostCells, warr: np.ndarray, acc: AccuracyModel,
           res: np.ndarray, assign: np.ndarray) -> np.ndarray:
    """`marginal_costs` on host copies: `res` the (C, N) resolutions."""
    h = hc.fields
    g = h["gain"]
    C, N = g.shape
    # device n's current resolution, read from its serving cell's lane
    s_dev = res[np.clip(assign, 0, C - 1), np.arange(N)]      # (N,)

    served = hc.active & (assign >= 0)
    load = np.bincount(assign[served], minlength=C)           # (C,)
    member = assign[None, :] == np.arange(C)[:, None]         # (C, N)
    share = load[:, None] - member + 1.0                      # n joins cell c
    b = h["bandwidth_total"] / share
    p = h["p_max"]
    r = b * np.log2(1.0 + g * p / (h["noise_psd"]
                                   * np.maximum(b, _TINY_BAND)))
    t_tx = h["bits"] / np.maximum(r, _TINY_RATE)
    e_tx = p * t_tx

    zeta = 1.0 / h["s_standard"] ** 2
    cycles_rt = h["local_iters"] * zeta * s_dev[None, :] ** 2 \
        * h["cycles"] * h["samples"]
    f = h["f_max"]
    t_cp = cycles_rt / np.maximum(f, _TINY_FREQ)
    e_cp = h["kappa"] * cycles_rt * f ** 2

    a_dev = acc.value(torch.as_tensor(s_dev, dtype=torch.float64))
    a_dev = np.asarray(a_dev.numpy(), np.float64)[None, :]
    rg = h["global_rounds"]
    w = np.asarray(warr, np.float64).reshape(C, 3)
    return rg * (w[:, :1] * (e_tx + e_cp) + w[:, 1:2] * (t_tx + t_cp)) \
        - w[:, 2:3] * a_dev


def marginal_costs(sysb: SystemParams, warr: np.ndarray,
                   acc: AccuracyModel, alloc: Allocation,
                   assign: np.ndarray) -> np.ndarray:
    """(C, N) marginal weighted cost of serving device n at cell c.

    The estimate a device n weighs when shopping for a cell c: an equal
    bandwidth share of c's spectrum among its current members (excluding n
    itself), full power / frequency, and n's current resolution from its
    serving cell's solve, i.e. eqs. (1)-(11) at the prospective operating
    point, combined with cell c's weights:

        cost = R_g (w1 (E_tx + E_cmp) + w2 (T_tx + T_cmp)) - rho a(s_n)

    A *proposal* heuristic only: the accept / reject step judges the
    re-solved objective. Host float64 numpy, as the reference's.
    """
    res, = _to_host([alloc.resolution])
    return _costs(_host_cells(sysb), warr, acc, res, np.asarray(assign))


def greedy_assign(cost: np.ndarray, capacity: np.ndarray,
                  active: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Capacity-capped greedy: devices (in `order`) each take their
    cheapest cell with remaining capacity. Stable sorts throughout, so the
    result is bit-deterministic. Raises if capacity cannot cover every
    active device."""
    C, N = cost.shape
    pref = np.argsort(cost, axis=0, kind="stable")            # (C, N)
    assign = np.full(N, -1, dtype=np.int32)
    load = np.zeros(C, dtype=np.int64)
    for n in order:
        if not active[n]:
            continue
        for c in pref[:, n]:
            if load[c] < capacity[c]:
                assign[n] = c
                load[c] += 1
                break
        else:
            raise ValueError(
                "greedy_assign: per-cell capacities cannot serve every "
                "active device (sum(capacity) < active count)")
    return assign


def nearest_assignment(sysb: SystemParams, capacity: np.ndarray
                       ) -> np.ndarray:
    """The static baseline: every device takes its strongest-gain cell
    (capacity-capped; strongest achievable devices place first)."""
    cost = -sysb.gain.to(torch.float64).cpu().numpy()
    active = _base_active(sysb)
    order = np.argsort(cost.min(axis=0), kind="stable")
    return greedy_assign(cost, capacity, active, order)


def _cell_objectives(sysb: SystemParams, w: Tensor, acc: AccuracyModel,
                     alloc: Allocation) -> Tensor:
    """(C,) realized per-cell weighted objective of `alloc` under the
    masked system, on the device: eq. (12) per cell, every cell at once
    (`w` the (C, 3) weights); empty cells contribute exactly 0."""
    e = en.total_energy(sysb, alloc)[:, 0]
    t = en.total_time(sysb, alloc)[:, 0]
    a = en.total_accuracy(acc, alloc, sysb.active)[:, 0]
    return w[:, 0] * e + w[:, 1] * t - w[:, 2] * a


def _score(masked: SystemParams, w: Tensor, acc: AccuracyModel,
           alloc: Allocation):
    """(global objective, (C, N) host resolutions) of one solve: the outer
    step's one packed host copy."""
    objs, res = _to_host([_cell_objectives(masked, w, acc, alloc),
                          alloc.resolution])
    return float(objs.sum()), res


def _warm_init(prev_alloc: Allocation, cold_alloc: Allocation,
               assign: np.ndarray, proposal: np.ndarray, C: int
               ) -> Allocation:
    """Warm start for the re-solve of `proposal`: lanes of devices that
    kept their cell reuse the previous solution; moved (and masked) lanes
    take the cold init of the new masked system (a moved device's old lane
    falls back to the masked start B=0, p=pmax, f=fmax, s=s_lo)."""
    stay = (proposal == assign) & (proposal >= 0)
    keep = (proposal[None, :] == np.arange(C)[:, None]) & stay[None, :]
    keep = torch.as_tensor(keep, device=prev_alloc.bandwidth.device)

    def mix(prev, cold):
        return torch.where(keep, prev, cold)

    return Allocation(
        bandwidth=mix(prev_alloc.bandwidth, cold_alloc.bandwidth),
        power=mix(prev_alloc.power, cold_alloc.power),
        freq=mix(prev_alloc.freq, cold_alloc.freq),
        resolution=mix(prev_alloc.resolution, cold_alloc.resolution),
        s_relaxed=None if prev_alloc.s_relaxed is None
        else mix(prev_alloc.s_relaxed, cold_alloc.resolution),
        T=prev_alloc.T)   # (C,): SP1 re-derives T on the first BCD step


def solve_assoc(problem, spec=None, assign0: Optional[np.ndarray] = None
                ) -> AssocResult:
    """Run the BCD-over-association outer loop on a stacked (C, N) problem.

    This is the driver behind ``solve(Problem(..., assoc=AssocConfig()))``;
    call it directly to seed a specific initial association (`assign0`,
    e.g. a previous result's fixed point). The inner per-cell solves go
    through the one `solve()` dispatcher: a `Problem.mesh` splits them
    over the region mesh unchanged (`AssocResult.fleet` is then a
    `RegionResult`).
    """
    from ..api import Problem, SolverSpec, solve
    from ..api.problem import weights_leaf

    spec = SolverSpec() if spec is None else spec
    if spec.max_iters < 1:
        raise ValueError(
            "solve_assoc: the association loop scores re-solved objectives,"
            " so SolverSpec.max_iters must be >= 1")
    cfg = problem.assoc if problem.assoc is not None else AssocConfig()
    sysb = problem.system
    if sysb.gain.ndim != 2:
        raise ValueError(
            "solve_assoc: association needs a stacked (C, N) system whose "
            "row c holds every device's gain to cell c (assoc.make_multicell)")
    C, N = sysb.gain.shape
    acc = problem.acc if problem.acc is not None else default_accuracy()
    hc = _host_cells(sysb)
    active = hc.active
    capacity = cfg.per_cell_capacity(C, N)
    if int(capacity.sum()) < int(active.sum()):
        raise ValueError(
            f"solve_assoc: sum(capacity) = {int(capacity.sum())} cannot "
            f"serve {int(active.sum())} active devices")

    warr = weights_leaf(problem.weights, torch.float64, "cpu",
                        cells=C).numpy()
    w = torch.as_tensor(warr, dtype=sysb.dtype, device=sysb.device)

    def run(masked: SystemParams, init=None):
        res = solve(Problem(system=masked, weights=problem.weights,
                            acc=acc, init=init, mesh=problem.mesh), spec)
        return res, getattr(res, "fleet", res)

    if assign0 is None:
        assign = nearest_assignment(sysb, capacity)
    else:
        assign = np.asarray(assign0, np.int32).copy()
        load = np.bincount(assign[active & (assign >= 0)], minlength=C)
        if (load > capacity).any() or (active & (assign < 0)).any():
            raise ValueError("solve_assoc: assign0 is infeasible (capacity "
                             "overrun or unserved active device)")

    masked = sysb.with_assignment(assign)
    res, fleet = run(masked)
    obj, resolution = _score(masked, w, acc, fleet.allocation)
    objectives, moves = [obj], []

    converged = False
    attempted = 0
    for it in range(cfg.outer_iters):
        attempted += 1
        # one obs span per outer association iteration: the inner
        # re-solve's own "solve" span nests under it, so a trace splits
        # outer-loop time between proposal scoring and the re-solves
        with obs.span("assoc_iter", outer_iter=it):
            cost = _costs(hc, warr, acc, resolution, assign)
            cur = cost[np.clip(assign, 0, C - 1), np.arange(N)]
            best = cost.min(axis=0)
            order = np.argsort(-(cur - best), kind="stable")   # biggest saver
            proposal = greedy_assign(cost, capacity, active, order)
            if np.array_equal(proposal, assign):
                converged = True
                break
            new_masked = sysb.with_assignment(proposal)
            init = None
            if cfg.warm_start:
                init = _warm_init(fleet.allocation,
                                  initial_allocation(new_masked), assign,
                                  proposal, C)
            new_res, new_fleet = run(new_masked, init=init)
            new_obj, new_resolution = _score(new_masked, w, acc,
                                             new_fleet.allocation)
            if new_obj < obj:
                moves.append(int(np.sum(proposal != assign)))
                assign, masked = proposal, new_masked
                res, fleet, obj = new_res, new_fleet, new_obj
                resolution = new_resolution
                objectives.append(obj)
            else:
                converged = True   # the greedy proposal no longer helps
                break
    else:
        # outer_iters == 0 never proposes: the init IS the fixed point asked
        converged = cfg.outer_iters == 0

    return AssocResult(assignment=assign, fleet=res, objective=obj,
                       objectives=objectives, moves=moves,
                       outer_iters=attempted, converged=converged)
