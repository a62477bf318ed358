"""Benchmark algorithms the paper compares against (§VII, Table I).

Port of `repro/core/baselines.py`, for one cell ((N,) tensors):

* MinPixel   — random resource allocation, s fixed at the minimum resolution
               (the paper's "Benchmark algorithm").
* RandPixel  — random resource allocation, random resolution.
* CommOnly   — optimize (p, B) only; f fixed from the deadline, s random (§VII-C).
* CompOnly   — optimize (f, s) only; p = pmax, B = B/N (§VII-C).
* Scheme1    — Yang et al. [11]: FDMA energy minimization under a deadline,
               without resolution optimization (s = standard).
* the paper's conference algorithm [1]: joint (p, B, f) under a deadline,
               s pinned to the standard sample.

Random draws take a `torch.Generator` (or an integer seed) and are made on
the CPU in float64, then cast and moved, as `core.channel` draws systems:
the same seed gives the same allocation on every device. They are not
`jax.random`'s numbers; tests hold the random baselines to their
statistics and the deterministic ones to `repro` bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from .accuracy import AccuracyModel, default_accuracy
from .bcd import BCDResult, initial_allocation
from .channel import GeneratorLike, _generator
from .energy import cycles_per_round, rate
from .sp1 import solve_sp1_fixed_T
from .sp2 import r_min, solve_sp2
from .types import Allocation, SystemParams, Weights

Tensor = torch.Tensor


def _uniform(gen: torch.Generator, sys: SystemParams, lo, hi) -> Tensor:
    """(N,) draws from U[lo, hi) in the system's dtype and device."""
    u = torch.rand((sys.n,), generator=gen, dtype=torch.float64)
    lo = torch.as_tensor(lo, dtype=torch.float64)
    hi = torch.as_tensor(hi, dtype=torch.float64)
    return (lo + (hi - lo) * u).to(dtype=sys.dtype, device=sys.device)


def _random_resolutions(gen: torch.Generator, sys: SystemParams) -> Tensor:
    res = torch.as_tensor(sys.resolutions, dtype=sys.dtype)
    idx = torch.randint(0, len(sys.resolutions), (sys.n,), generator=gen)
    return res[idx].to(sys.device)


def _full(sys: SystemParams, value) -> Tensor:
    return torch.broadcast_to(torch.as_tensor(
        value, dtype=sys.dtype, device=sys.device), (sys.n,)).clone()


def min_pixel(sys: SystemParams, gen: GeneratorLike,
              sweep: str = "power") -> Allocation:
    """Paper §VII-B benchmark: fixed s = s_lo; in the power sweep, f random
    in [0.1, 2] GHz and p = pmax; in the frequency sweep, p random and
    f = fmax; B = B/N either way."""
    gen = _generator(gen)
    if sweep == "power":
        freq = _uniform(gen, sys, 0.1e9, sys.f_max.cpu())
        power = _full(sys, sys.p_max)
    else:
        freq = _full(sys, sys.f_max)
        power = _uniform(gen, sys, torch.clamp_min(sys.p_min.cpu(), 1e-4),
                         sys.p_max.cpu())
    return Allocation(bandwidth=_full(sys, sys.bandwidth_total / sys.n),
                      power=power, freq=freq,
                      resolution=_full(sys, sys.s_lo))


def rand_pixel(sys: SystemParams, gen: GeneratorLike,
               sweep: str = "power") -> Allocation:
    gen = _generator(gen)
    base = min_pixel(sys, gen, sweep=sweep)
    return Allocation(bandwidth=base.bandwidth, power=base.power,
                      freq=base.freq,
                      resolution=_random_resolutions(gen, sys))


def comm_only(sys: SystemParams, w: Weights, T_total: float,
              gen: GeneratorLike, acc: Optional[AccuracyModel] = None,
              max_iters: int = 10) -> Allocation:
    """§VII-C: only (p, B) optimized (Algorithm 1 restarted `max_iters`
    times). f is pinned from constraint (13a):
    f_n = Rg Rl zeta s^2 c D / (T - Rg max(d/r)), s random."""
    s = _random_resolutions(_generator(gen), sys)
    init = initial_allocation(sys)
    r0 = rate(sys, init.bandwidth, init.power)
    T_round = T_total / sys.global_rounds
    tt0 = float((sys.bits / r0).amax())
    f = torch.minimum(torch.maximum(
        cycles_per_round(sys, s) / torch.clamp_min(T_round - tt0, 1e-6),
        sys.f_min), sys.f_max)
    rmin = r_min(sys, f, s, T_round)
    p, B = init.power, init.bandwidth
    for _ in range(max_iters):
        sp2 = solve_sp2(sys, w.normalized(), rmin, p, B)
        p, B = sp2.power, sp2.bandwidth
    return Allocation(bandwidth=B, power=p, freq=f, resolution=s, T=T_round)


def comp_only(sys: SystemParams, w: Weights, T_total: float,
              acc: Optional[AccuracyModel] = None) -> Allocation:
    """§VII-C: only (f, s) optimized; p = pmax, B = B/N."""
    acc = acc if acc is not None else default_accuracy()
    init = initial_allocation(sys)
    T_round = T_total / sys.global_rounds
    f, s = solve_sp1_fixed_T(sys, w.normalized(), acc, init.bandwidth,
                             init.power, T_round)
    return Allocation(bandwidth=init.bandwidth, power=init.power, freq=f,
                      resolution=s, T=T_round)


def scheme1(sys: SystemParams, w: Weights, T_total: float,
            acc: Optional[AccuracyModel] = None) -> Allocation:
    """Yang et al. [11] comparison baseline ("Scheme 1"), as the reference
    builds its proxy: equal bandwidth B/N, maximum power, s = the standard
    sample, and per device the minimum CPU frequency that meets the
    deadline."""
    T_round = T_total / sys.global_rounds
    B = _full(sys, sys.bandwidth_total / sys.n)
    p = _full(sys, sys.p_max)
    tt = sys.bits / torch.clamp_min(rate(sys, B, p), 1e-12)
    s = _full(sys, sys.s_standard)
    f = torch.minimum(torch.maximum(
        cycles_per_round(sys, s) / torch.clamp_min(T_round - tt, 1e-9),
        sys.f_min), sys.f_max)
    return Allocation(bandwidth=B, power=p, freq=f, resolution=s, T=T_round)


def conference_version(sys: SystemParams, w: Weights, T_total: float,
                       max_iters: int = 10) -> BCDResult:
    """The paper's ICDCS conference algorithm [1]: joint (p, B, f) under a
    deadline, no resolution variable (s pinned to the standard sample) —
    what Fig. 9 compares against Scheme 1."""
    from ..api import Problem, SolverSpec, solve

    pinned = sys.replace(resolutions=(float(sys.s_standard),))
    return solve(Problem(system=pinned, weights=Weights(w.w1, w.w2, 0.0),
                         acc=default_accuracy(), deadline=T_total),
                 SolverSpec(max_iters=max_iters))
