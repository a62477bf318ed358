"""Subproblem 1 (paper §V-A, Appendix B): optimize (f, s, T) given (p, B).

Port of `repro/core/sp1.py`, the default `method="sweep"` engine for the
paper's LinearAccuracy:

    min_{f, s_hat, T}  w1 Rg sum_n alpha_n s_hat^2 f^2 + w2 Rg T - rho sum_n A_n(s_hat)
    s.t. f in [fmin, fmax], s_hat in [s_lo, s_hi],
         q_n s_hat^2 / f + T_trans_n <= T

The KKT system (eqs. A.2-A.7) is solved by water-filling on the scalar map
T -> Sigma_n lambda_n(T): every round evaluates Sigma_n lambda_n(T) for a
geometric grid of candidate deadlines in one pass of the `sp1_lambda_sum`
kernel (all cells at once), narrows to the sign-change bracket, and the
last bracket ends with a secant step.

Every tensor carries the cell axis: (C, N) per device, (C, 1) per cell.
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops as kops
from ..kernels.sp1_sweep import N_CONSTS, _cbrt, lambda_of_T_linear
from .accuracy import AccuracyModel, LinearAccuracy
from .types import SystemParams, Weights

Tensor = torch.Tensor

# `_SWEEP_ROUNDS` rounds of `_SWEEP_POINTS`-point grids shrink the bracket
# by (points-1)^rounds: 3 x 16 resolves the default [T_lo, T_hi] range to
# ~5e-3 relative before the secant step
_SWEEP_POINTS = 16
_SWEEP_ROUNDS = 3
_LOG10_E = math.log10(math.e)


def _later_slice(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"repro_torch: {what} is not ported yet (a later slice; see "
        f"ROADMAP.md Queue 1)")


def _coeffs(sys: SystemParams, w: Weights):
    """alpha_n (energy coeff, incl. w1 Rg) and q_n (cycles per s^2)."""
    q = sys.local_iters * sys.zeta * sys.cycles * sys.samples
    alpha = w.w1 * sys.global_rounds * sys.kappa * q
    return alpha, q


def _f_of_lambda(sys: SystemParams, w: Weights, lam: Tensor) -> Tensor:
    # dtype-aware guard: w1 == 0 (pure latency weighting) would make this
    # cbrt(0/0) = NaN at lam = 0
    tiny = torch.finfo(lam.dtype).tiny
    f_unc = _cbrt(lam / torch.clamp_min(
        2.0 * w.w1 * sys.global_rounds * sys.kappa, tiny))
    return torch.minimum(torch.maximum(f_unc, sys.f_min), sys.f_max)


def _s_of_lambda(sys: SystemParams, w: Weights, acc: AccuracyModel,
                 lam: Tensor) -> Tensor:
    """Solve s*(2 a f^2 + 2 lam q / f) = rho A'(s) on [s_lo, s_hi]."""
    if not isinstance(acc, LinearAccuracy):
        raise _later_slice("SP1 for a non-linear accuracy model")
    alpha, q = _coeffs(sys, w)
    f = _f_of_lambda(sys, w, lam)
    psi = 2.0 * alpha * (f * f) + 2.0 * lam * q / torch.clamp_min(f, 1e-9)
    s_unc = w.rho * acc.slope / torch.clamp_min(psi,
                                                torch.finfo(psi.dtype).tiny)
    return torch.clamp(s_unc, sys.s_lo, sys.s_hi)


def round_resolution(sys: SystemParams, s_hat: Tensor) -> Tensor:
    """Discrete mapping of eq. (20): nearest resolution (first on a tie)."""
    res = torch.as_tensor(sys.resolutions, dtype=s_hat.dtype,
                          device=s_hat.device)
    idx = (s_hat[..., None] - res).abs().argmin(-1)
    return res[idx]


def _sp1_bounds(sys: SystemParams, w: Weights, q: Tensor, tt: Tensor):
    """(lam_hi, target, T_lo, T_hi), each (C, 1)."""
    f_max = sys.f_max
    lam_hi = torch.clamp_min(torch.maximum(
        2.0 * w.w1 * sys.global_rounds * sys.kappa * (f_max * f_max * f_max),
        w.w2 * sys.global_rounds), 1.0) * 1e4
    target = w.w2 * sys.global_rounds
    T_lo = (q * sys.s_lo ** 2 / sys.f_max + tt).amax(-1, keepdim=True) \
        * (1.0 + 1e-12)
    T_hi = (q * sys.s_hi ** 2 / torch.clamp_min(sys.f_min, 1e-3)
            + tt).amax(-1, keepdim=True) * 2.0
    return lam_hi, target, T_lo, T_hi


def _finish_sp1(sys: SystemParams, w: Weights, acc: AccuracyModel,
                q: Tensor, lam: Tensor, tt: Tensor, T: Tensor):
    f = _f_of_lambda(sys, w, lam)                      # eq. (19)
    s_hat = _s_of_lambda(sys, w, acc, lam)
    s = round_resolution(sys, s_hat)                   # eq. (20)
    # makespan consistent with the discrete s (feeds SP2's r_min)
    T_out = (q * (s * s) / torch.clamp_min(f, 1e-9) + tt).amax(-1,
                                                               keepdim=True)
    return f, s, s_hat, torch.maximum(T, T_out)


def _geomspace(lo: Tensor, hi: Tensor, n: int) -> Tensor:
    """jnp.geomspace(lo, hi, n) for positive (C, 1) endpoints -> (C, n):
    10 ** linspace(log10 lo, log10 hi), with jnp.linspace's formula
    (start (1 - i/(n-1)) + stop i/(n-1), the stop appended as it is) and
    log10 as XLA forms it (log(x) * log10(e)), since the grid points feed
    the bracket pick."""
    a, b = torch.log(lo) * _LOG10_E, torch.log(hi) * _LOG10_E
    step = torch.arange(n - 1, dtype=lo.dtype, device=lo.device) / (n - 1)
    return torch.pow(10.0, torch.cat([a * (1 - step) + b * step, b], -1))


def _sweep_consts(sys: SystemParams, w: Weights, acc: LinearAccuracy,
                  lam_hi: Tensor) -> Tensor:
    """The kernel's (C, N_CONSTS) coefficient rows:
    [k3, rho*slope, f_min, f_max, s_lo, s_hi, lam_hi, 0]."""
    cols = (2.0 * w.w1 * sys.global_rounds * sys.kappa, w.rho * acc.slope,
            sys.f_min, sys.f_max, sys.s_lo, sys.s_hi, lam_hi)
    consts = torch.zeros((lam_hi.shape[0], N_CONSTS), dtype=lam_hi.dtype,
                         device=lam_hi.device)
    for i, c in enumerate(cols):
        consts[:, i:i + 1] = c
    return consts


def _solve_sp1_sweep_impl(sys: SystemParams, warr: Tensor,
                          acc: AccuracyModel, tt: Tensor):
    """Batched T-grid sweep engine (method="sweep"): sys batched, warr
    (C, 3) = (w1, max(w2, 1e-9), rho), tt (C, N). Returns (f, s, s_hat, T)
    with T (C, 1)."""
    if not isinstance(acc, LinearAccuracy):
        raise _later_slice("the SP1 sweep for a non-linear accuracy model")
    w = Weights(warr[:, 0:1], warr[:, 1:2], warr[:, 2:3])
    _, q = _coeffs(sys, w)
    lam_hi, target, T_lo, T_hi = _sp1_bounds(sys, w, q, tt)
    tiny = torch.finfo(T_lo.dtype).tiny

    consts = _sweep_consts(sys, w, acc, lam_hi)
    k3, rhok = consts[:, 0:1], consts[:, 1:2]

    n = _SWEEP_POINTS
    index = torch.arange(n, device=T_lo.device)
    lo, hi = T_lo, T_hi
    S_lo = S_hi = None
    for _ in range(_SWEEP_ROUNDS):
        grid = _geomspace(lo, hi, n)
        S = kops.sp1_lambda_sum(grid, q, tt, consts)
        # Sigma lambda(T) is nonincreasing in T; bracket its target crossing
        under = S < target
        first = torch.where(under, index, n).amin(-1, keepdim=True)
        idx = torch.where(first == n, n - 1, torch.clamp_min(first, 1))
        lo, hi = grid.gather(-1, idx - 1), grid.gather(-1, idx)
        S_lo, S_hi = S.gather(-1, idx - 1), S.gather(-1, idx)
    t = torch.clamp((S_lo - target) / torch.clamp_min(S_lo - S_hi, tiny),
                    0.0, 1.0)
    T = lo + t * (hi - lo)
    lam = lambda_of_T_linear(T, q, tt, k3, rhok, sys.f_min, sys.f_max,
                             sys.s_lo, sys.s_hi, lam_hi)
    return _finish_sp1(sys, w, acc, q, lam, tt, T)


def dual_evals_per_iter(sp1_method: str, acc: AccuracyModel) -> int:
    """SP1 Sigma-lambda(T) dual evaluations one BCD iteration spends,
    counted at the candidate-deadline level; the +1 is the final lambda(T)
    inversion at the secant T."""
    if sp1_method != "sweep" or not isinstance(acc, LinearAccuracy):
        raise _later_slice(f"SP1 method {sp1_method!r} with "
                           f"{type(acc).__name__}")
    return _SWEEP_POINTS * _SWEEP_ROUNDS + 1
