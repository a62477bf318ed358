"""Pareto-frontier sweeps over the weight simplex, every point in one batch.

Port of `repro/diff/pareto.py`. The energy/latency trade-off curve (the
paper's Fig. 5 axis) is a sweep of the scalarization weight w1 (with
w2 = 1 - w1, rho fixed). Weights are data, so the whole sweep lowers to
the fleet path: the single cell is replicated across a (C, N) stack, the
(C, 3) weight grid rides along, and `solve_and_grad` solves and
differentiates every point in one batched graph. The per-point weight
gradients give the frontier's local exchange rates dE/dw, dT/dw beside
the frontier itself.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..api.problem import Problem
from ..api.spec import SolverSpec
from ..core.bcd import stack_systems
from ..core.types import Weights
from .implicit import METRICS, solve_and_grad

__all__ = ["ParetoResult", "pareto_front", "pareto_sweep", "weight_grid"]


def weight_grid(n: int = 17, rho: float = 0.3, lo: float = 0.05,
                hi: float = 0.95) -> np.ndarray:
    """(n, 3) raw weight rows walking the w1-w2 simplex edge: w1 linear in
    [lo, hi], w2 = 1 - w1, rho fixed. Endpoints stay off the degenerate
    corners — w1 or w2 = 0 collapses a whole objective term and the BCD
    map can lose its contraction there."""
    if not 0.0 < lo < hi < 1.0:
        raise ValueError(f"weight_grid: need 0 < lo < hi < 1, "
                         f"got ({lo}, {hi})")
    w1 = np.linspace(lo, hi, int(n))
    return np.stack([w1, 1.0 - w1, np.full(int(n), float(rho))], axis=-1)


def pareto_front(energy, time) -> np.ndarray:
    """Boolean non-dominated mask for jointly minimizing (energy, time).

    A point is on the front iff no other point is at least as good on both
    axes and strictly better on one. Ties keep both points. NaN entries
    (non-converged sweeps) never dominate and never join the front.
    """
    e = np.asarray(energy, float)
    t = np.asarray(time, float)
    if e.shape != t.shape or e.ndim != 1:
        raise ValueError(
            f"pareto_front: energy/time must be matching 1-D arrays, got "
            f"{e.shape} vs {t.shape}")
    ok = np.isfinite(e) & np.isfinite(t)
    mask = ok.copy()
    for i in np.nonzero(ok)[0]:
        dom = ok & (e <= e[i]) & (t <= t[i]) & ((e < e[i]) | (t < t[i]))
        if dom.any():
            mask[i] = False
    return mask


@dataclasses.dataclass(frozen=True)
class ParetoResult:
    """Outcome of `pareto_sweep` (host numpy, plot-ready).

    weights : the (n, 3) raw weight grid swept.
    value : metric -> (n,) realized values.
    grads : metric -> (n, 3) gradients w.r.t. the raw weight rows.
    converged : (n,) BCD convergence flags from the forward solve.
    front : (n,) non-dominated mask over (energy, time), restricted to
        converged points.
    """
    weights: np.ndarray
    value: Dict[str, np.ndarray]
    grads: Dict[str, np.ndarray]
    converged: np.ndarray
    front: np.ndarray


def pareto_sweep(problem: Problem, spec: Optional[SolverSpec] = None, *,
                 n: int = 17, rho: Optional[float] = None,
                 grid: Optional[np.ndarray] = None,
                 adjoint_iters: int = 30) -> ParetoResult:
    """Trace the energy/time frontier of a single-cell problem.

    Replicates the cell over an `n`-point weight grid (or an explicit
    `grid` of raw (n, 3) rows) and runs one vmapped solve-and-grad plus
    one vmapped forward solve (for the convergence flags). rho defaults
    to the problem's own accuracy weight.
    """
    if problem.cells is not None:
        raise ValueError("pareto_sweep: single-cell problems only")
    if grid is None:
        if rho is None:
            w = problem.weights
            rho = float(w.rho) if isinstance(w, Weights) \
                else float(torch.as_tensor(w).reshape(-1)[-1])
        grid = weight_grid(n, rho=rho)
    grid = np.asarray(grid, float)
    if grid.ndim != 2 or grid.shape[1] != 3:
        raise ValueError(f"pareto_sweep: grid must be (n, 3) raw weight "
                         f"rows, got {grid.shape}")
    c = grid.shape[0]

    stacked = stack_systems([problem.system] * c)
    swept = dataclasses.replace(problem, system=stacked,
                                weights=torch.as_tensor(grid))
    g = solve_and_grad(swept, spec, wrt=(), adjoint_iters=adjoint_iters)

    from ..api.solve import solve   # local: avoid import cycle
    fwd = solve(swept, spec)
    converged = fwd.converged.cpu().numpy().astype(bool).reshape(c)

    value = {m: g.value[m].double().cpu().numpy() for m in METRICS}
    grads = {m: g.grads[m]["weights"].double().cpu().numpy()
             for m in METRICS}
    e = np.where(converged, value["energy"], np.nan)
    t = np.where(converged, value["time"], np.nan)
    return ParetoResult(weights=grid, value=value, grads=grads,
                        converged=converged,
                        front=pareto_front(e, t))
