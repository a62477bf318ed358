"""Weight auto-tuning: descend the solver's own gradient to hit a target.

Port of `repro/diff/tune.py`.

The paper's scalarization (w1 E + w2 T - rho A) leaves the operator with an
inverse problem: *which weights* make the realized allocation meet a latency
budget at minimum energy? With `solve_and_grad` the chain

    raw (w1, w2)  ->  normalized weights  ->  BCD fixed point  ->  (E, T)

is differentiable end to end, so the tuner is plain projected gradient
descent on the log-raw weights against the penalty scalarization

    L(w) = E(w) / E_ref  +  penalty * max(0, T(w) / target - 1)^2

(`E_ref` is the energy at the starting weights, making the two terms
commensurate). rho is held fixed: it prices accuracy, which the latency
budget says nothing about — but note the normalization divides rho by
w1 + w2, so jointly scaling (w1, w2) still re-weights accuracy and the
descent has two genuine degrees of freedom.

The loop runs on the host; each iterate is one `solve_and_grad` call (one
solve and one backward pass). `target_from_slos` bridges the SLO plane: a
latency objective's threshold (anything with `threshold_s`), read as a
per-global-round deadline, becomes the tuner's `target_time`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

import torch

from ..api.problem import Problem
from ..api.spec import SolverSpec
from ..core.types import Weights
from .implicit import solve_and_grad

__all__ = ["TuneResult", "target_from_slos", "tune_weights"]

#: log-space box for the raw (w1, w2) iterates: wide enough for any
#: sensible trade-off, tight enough to keep the normalized rho finite
_Z_LO, _Z_HI = math.log(1e-3), math.log(1e3)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of `tune_weights`.

    weights : the best raw `Weights` found (feed them straight back into a
        `Problem` — the solvers normalize internally).
    value : realized metrics at those weights (objective/energy/time/
        accuracy, host floats).
    target_time : the latency budget tuned against.
    met : whether the returned weights meet the budget (time <= target).
    steps : gradient steps actually taken.
    history : one dict per step (w1, w2, energy, time, loss, violation) —
        ready for plotting / assertions.
    """
    weights: Weights
    value: Dict[str, float]
    target_time: float
    met: bool
    steps: int
    history: Tuple[Dict[str, float], ...]


def target_from_slos(slos: Sequence, global_rounds: float = 1.0) -> float:
    """Latency budget implied by an SLO set.

    Scans for the first objective exposing `threshold_s` (a
    `LatencyObjective`) and scales it by `global_rounds`: the SLO speaks
    per-round service latency, the allocator's T is the full training
    makespan. Keeping the allocation's per-round share under the threshold
    is what drives that SLO's burn rate toward zero.
    """
    for slo in slos:
        src = getattr(slo, "source", slo)
        thr = getattr(src, "threshold_s", None)
        if thr is not None:
            return float(thr) * float(global_rounds)
    raise ValueError(
        "target_from_slos: no latency objective (threshold_s) in the SLO "
        "set — pass target_time explicitly")


def tune_weights(problem: Problem, spec: Optional[SolverSpec] = None, *,
                 target_time: Optional[float] = None,
                 slos: Optional[Sequence] = None,
                 steps: int = 24, lr: float = 0.3, penalty: float = 40.0,
                 adjoint_iters: int = 30) -> TuneResult:
    """Tune (w1, w2) so the realized allocation hits `target_time` at
    minimum energy (module docstring). Exactly one of `target_time` /
    `slos` must be given. Returns the best iterate seen: the lowest-energy
    feasible one, or the least-infeasible one when the budget was never
    met within `steps`.
    """
    if (target_time is None) == (slos is None):
        raise ValueError(
            "tune_weights: pass exactly one of target_time= or slos=")
    if target_time is None:
        target_time = target_from_slos(
            slos, float(problem.system.global_rounds.max()))
    if target_time <= 0:
        raise ValueError(f"tune_weights: target_time must be positive, "
                         f"got {target_time}")
    if problem.cells is not None:
        raise ValueError("tune_weights: single-cell problems only "
                         "(sweep fleets with diff.pareto instead)")

    w = problem.weights if isinstance(problem.weights, Weights) \
        else Weights(*torch.as_tensor(problem.weights).double().tolist())
    wr = np.asarray([float(w.w1), float(w.w2), float(w.rho)], float)
    z = np.clip(np.log(wr[:2]), _Z_LO, _Z_HI)

    e_ref = None
    best = None          # (feasible, key, wr, value)
    history = []
    taken = 0
    for _ in range(steps):
        taken += 1
        wr[:2] = np.exp(z)
        g = solve_and_grad(
            dataclasses.replace(problem, weights=Weights(*wr)),
            spec, wrt=(), adjoint_iters=adjoint_iters)
        val = {m: float(v) for m, v in g.value.items()}
        energy, t = val["energy"], val["time"]
        if e_ref is None:
            e_ref = max(energy, 1e-30)
        viol = max(t / target_time - 1.0, 0.0)
        loss = energy / e_ref + penalty * viol ** 2
        history.append(dict(w1=wr[0], w2=wr[1], energy=energy, time=t,
                            loss=loss, violation=viol))
        if not math.isfinite(loss):
            break
        feasible = viol <= 0.0
        key = energy if feasible else viol
        if best is None or (feasible, ) > (best[0], ) \
                or (feasible == best[0] and key < best[1]):
            best = (feasible, key, wr.copy(), val)

        d_e = g.grads["energy"]["weights"].double().cpu().numpy()
        d_t = g.grads["time"]["weights"].double().cpu().numpy()
        d_l = d_e / e_ref + 2.0 * penalty * viol * d_t / target_time
        dz = d_l[:2] * wr[:2]             # chain rule through w = exp(z)
        if feasible and float(np.max(np.abs(dz))) < 1e-4:
            break                          # on budget, locally stationary
        z = np.clip(z - lr * dz, _Z_LO, _Z_HI)

    assert best is not None, "tune_weights: zero steps requested"
    feasible, _, wr_best, val_best = best
    return TuneResult(weights=Weights(*wr_best), value=val_best,
                      target_time=float(target_time), met=bool(feasible),
                      steps=taken, history=tuple(history))
