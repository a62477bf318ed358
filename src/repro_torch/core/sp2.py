"""Subproblem 2 (paper §V-B/C, Appendix D): optimize (p, B) given (f, s, T).

Port of `repro/core/sp2.py`:

    min_{p,B} w1 Rg sum_n p_n d_n / G_n(p_n, B_n)
    s.t. sum B_n <= B, 0 <= B_n, pmin <= p_n <= pmax,
         G_n(p_n, B_n) >= r_n^min = d_n / (T - T_cmp_n)

Three engines, as in the reference:

  * `direct` (the default): the per-device energy E(p) = p d / G(p, B) is
    strictly increasing in p, so the optimal power sits on the boundary
    p* = max(pmin, p_rate(B)); SP2 collapses to a separable convex program
    over B with one budget constraint, solved exactly by a bisection on
    its multiplier mu around a safeguarded Newton search for each
    device's B*(mu) (`solve_sp2_direct`; the non-carried, pure-bisection
    forms are its parity oracles).
  * `jong`, the paper's Algorithm 1 (`solve_sp2`): a damped Newton-like
    update of the parametric duals (nu, beta) (Jong's transform, eqs.
    24-30) around an exact separable solve of the subtractive form SP2_v2
    (eq. 22; `solve_sp2_v2`: golden section per device inside a bisection
    on the budget multiplier).
  * the paper-literal Appendix-D path (`solve_sp2_v2_thm2`): the
    Lambert-W dual (A.22/A.23), whose root is found by sweeping g'(mu)
    through the `waterfill_gprime` kernel, and Theorem 2's closed forms.

Every tensor carries the cell axis: (C, N) per device, (C, 1) per cell;
the public `solve_*` functions also take one cell's (N,) tensors and
answer in the same layout. The data-dependent searches run as
`loops.while_cells`, with the same per-cell exits as the reference's
`vmap` of `lax.while_loop`; fixed-trip searches are plain loops with no
host read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import torch

from ..kernels import ops as kops
from .energy import log2
from .lambertw import lambertw0
from .loops import while_cells
from .sp1 import _cells_view, _geomspace
from .types import SystemParams, Weights

Tensor = torch.Tensor

_LN2 = math.log(2.0)
_GOLD = 0.6180339887498949


def _exp2(x: Tensor) -> Tensor:
    """2**x as exp(x ln2), the form XLA evaluates `jnp.exp2` in: it keeps
    the dual search's data-dependent exits closer to where the reference's
    land (torch.exp2 differs from it by a few ulps on most inputs)."""
    return torch.exp(x * _LN2)


def G(sys: SystemParams, p: Tensor, B: Tensor) -> Tensor:
    """G_n(p,B) = B log2(1 + g p / (N0 B)) — the rate (eq. 1), concave (Lemma 1)."""
    b = torch.clamp_min(B, 1e-12)
    return b * log2(1.0 + sys.gain * p / (sys.noise_psd * b))


def r_min(sys: SystemParams, freq: Tensor, resolution: Tensor,
          T_round: Tensor) -> Tensor:
    """r_n^min = d_n / (T - R_l zeta s^2 c D / f)   (§V-B)."""
    t_cmp = sys.local_iters * sys.zeta * (resolution * resolution) \
        * sys.cycles * sys.samples / torch.clamp_min(freq, 1e-9)
    slack = torch.clamp_min(T_round - t_cmp, 1e-9)
    return sys.bits / slack


def _clamp_rmin(sys: SystemParams, rmin: Tensor) -> Tensor:
    """Rates above the infinite-bandwidth asymptote g pmax/(N0 ln2) are
    unattainable at any bandwidth; clamp with margin (deadline soft-missed)."""
    asym = sys.gain * sys.p_max / (sys.noise_psd * _LN2)
    return torch.minimum(rmin, 0.95 * asym)


def _search_iters(dtype: torch.dtype, f32_iters: int = 34,
                  f64_iters: int = 56) -> int:
    """Iteration count for bracketing searches, matched to the dtype."""
    return f32_iters if torch.finfo(dtype).bits <= 32 else f64_iters


def _mask_box(sys: SystemParams, b_lo: Tensor, b_hi: Tensor):
    """Collapse padded-out devices' bandwidth box to [0, 0], so that every
    inner search pins them at exactly 0."""
    if sys.active is None:
        return b_lo, b_hi
    zero = torch.zeros((), dtype=b_lo.dtype, device=b_lo.device)
    return (torch.where(sys.active, b_lo, zero),
            torch.where(sys.active, b_hi, zero))


def _b_min(sys: SystemParams, rmin: Tensor, iters: int | None = None) -> Tensor:
    """Smallest bandwidth at which G(pmax, B) >= rmin (G increasing in B)."""
    if iters is None:
        iters = _search_iters(rmin.dtype, f32_iters=30)
    lo = torch.full_like(rmin, 1e-3)
    hi = torch.broadcast_to(sys.bandwidth_total, rmin.shape)
    p_max = torch.broadcast_to(sys.p_max, rmin.shape)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = G(sys, p_max, mid) >= rmin
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    return hi


def _p_rate(sys: SystemParams, rmin: Tensor, B: Tensor) -> Tensor:
    """Power that makes the rate constraint tight at bandwidth B."""
    theta_req = _exp2(rmin / torch.clamp_min(B, 1e-9)) - 1.0
    return theta_req * sys.noise_psd * B / sys.gain


def _denergy_dB(sys: SystemParams, rmin: Tensor, B: Tensor) -> Tensor:
    """dE_n/dB for E_n(B) = p~(B) d / G(p~(B), B), p~ = clip(p_rate, pmin,
    pmax):
      * rate branch (pmin <= p_rate <= pmax, G == rmin exactly):
          dE/dB = (N0 d / (g rmin)) (2^x (1 - x ln2) - 1),  x = rmin/B
      * clipped branch (p = pc in {pmin, pmax} constant):
          dE/dB = -pc d G'(pc, B) / G(pc, B)^2,
          G' = (ln(1+t) - t/(1+t)) / ln2, t = g pc / (N0 B)
    """
    N0, g, d = sys.noise_psd, sys.gain, sys.bits
    Bs = torch.clamp_min(B, 1e-12)
    x = rmin / Bs
    ex = _exp2(x)
    p_rate = (ex - 1.0) * N0 * Bs / g
    dE_rate = (N0 * d / (g * torch.clamp_min(rmin, 1e-30))) \
        * (ex * (1.0 - x * _LN2) - 1.0)
    pc = torch.where(p_rate < sys.p_min, sys.p_min, sys.p_max)
    t = g * pc / (N0 * Bs)
    L = torch.log1p(t)
    Gc = torch.clamp_min(Bs * L / _LN2, 1e-12)
    Gp = (L - t / (1.0 + t)) / _LN2
    dE_clip = -pc * d * Gp / (Gc * Gc)
    on_rate = (p_rate >= sys.p_min) & (p_rate <= sys.p_max)
    return torch.where(on_rate, dE_rate, dE_clip)


def _denergy2_dB2(sys: SystemParams, rmin: Tensor, B: Tensor) -> Tensor:
    """d^2E_n/dB^2 for both branches of `_denergy_dB` (strictly positive):
      * rate branch:    E'' = (N0 d / (g rmin)) 2^x (x ln2)^2 / B
      * clipped branch: E'' = pc d (2 G'^2 - G'' G) / G^3,
                        G'' = -t^2 / (ln2 B (1+t)^2)
    """
    N0, g, d = sys.noise_psd, sys.gain, sys.bits
    Bs = torch.clamp_min(B, 1e-12)
    x = rmin / Bs
    ex = _exp2(x)
    p_rate = (ex - 1.0) * N0 * Bs / g
    xl = x * _LN2
    d2_rate = (N0 * d / (g * torch.clamp_min(rmin, 1e-30))) * ex \
        * (xl * xl) / Bs
    pc = torch.where(p_rate < sys.p_min, sys.p_min, sys.p_max)
    t = g * pc / (N0 * Bs)
    L = torch.log1p(t)
    Gc = torch.clamp_min(Bs * L / _LN2, 1e-12)
    Gp = (L - t / (1.0 + t)) / _LN2
    t1 = 1.0 + t
    Gpp = -(t * t) / (_LN2 * Bs * (t1 * t1))
    d2_clip = pc * d * (2.0 * (Gp * Gp) - Gpp * Gc) / (Gc * Gc * Gc)
    on_rate = (p_rate >= sys.p_min) & (p_rate <= sys.p_max)
    return torch.where(on_rate, d2_rate, d2_clip)


def sp2_stationarity(sys: SystemParams, rmin: Tensor, B: Tensor,
                     mu: Tensor) -> Tensor:
    """Per-lane KKT stationarity residual of the direct SP2 waterfilling:
    psi_n = dE_n/dB(B_n) + mu (zero on interior lanes at the optimum;
    positive where a lane is pinned at its rate floor b_min).
    `repro_torch.diff.implicit` linearizes it (with the curvature
    `_denergy2_dB2`) to differentiate through the SP2 solve."""
    return _denergy_dB(sys, _clamp_rmin(sys, rmin), B) + mu


def _budget_box(sys: SystemParams, rmin: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-device bandwidth box [b_lo, b_hi] of the budget search, (C, N):
    the rate floors b_min (scaled to fit 0.999 of the budget when they alone
    exceed it: an infeasible deadline gets best-effort floors) up to the
    whole budget; padded-out devices get [0, 0]."""
    Btot = sys.bandwidth_total                          # (C, 1)
    b_lo = _b_min(sys, rmin)
    b_lo, _ = _mask_box(sys, b_lo, b_lo)
    fit = torch.clamp_max(0.999 * Btot / torch.clamp_min(
        b_lo.sum(-1, keepdim=True), 1e-30), 1.0)
    b_lo = b_lo * fit
    b_hi = torch.maximum(torch.broadcast_to(Btot, b_lo.shape), b_lo)
    return _mask_box(sys, b_lo, b_hi)


# ----------------------------------------------------------------------------
# SP2_v2: the subtractive form of Jong's transform, solved exactly
# ----------------------------------------------------------------------------

def _p_star(sys: SystemParams, beta: Tensor, rmin: Tensor, B: Tensor
            ) -> Tensor:
    """Optimal power for fixed B in SP2_v2 (A.16 clipped to box & rate)."""
    N0, g, d = sys.noise_psd, sys.gain, sys.bits
    # padded lanes (d = 0) would give 0/0 here; real devices have
    # N0 d ln2 ~ 1e-16 >> tiny, so the guard is bit-exact for them
    denom = torch.clamp_min(N0 * d * _LN2, torch.finfo(B.dtype).tiny)
    lam0 = beta * g / denom
    p_int = torch.clamp_min(lam0 - 1.0, 0.0) * N0 * B / g
    theta_req = _exp2(rmin / torch.clamp_min(B, 1e-9)) - 1.0
    p_rate = theta_req * N0 * B / g
    return torch.minimum(torch.maximum(p_int, torch.maximum(sys.p_min,
                                                            p_rate)),
                         sys.p_max)


def _h(sys: SystemParams, nu: Tensor, beta: Tensor, rmin: Tensor,
       B: Tensor) -> Tensor:
    """Per-device SP2_v2 objective h_n(B) after minimizing over p."""
    p = _p_star(sys, beta, rmin, B)
    return nu * (p * sys.bits - beta * G(sys, p, B))


def _golden_argmin(fn, lo: Tensor, hi: Tensor, iters: int | None = None
                   ) -> Tensor:
    """Memoized golden section, elementwise: the surviving interior point is
    reused, so each step evaluates `fn` once. Fixed trip count (the
    dtype-matched `_search_iters` by default), so no host read."""
    if iters is None:
        iters = _search_iters(lo.dtype)
    a, b = lo, hi
    c = hi - _GOLD * (hi - lo)
    d = lo + _GOLD * (hi - lo)
    fc, fd = fn(c), fn(d)
    for _ in range(iters):
        left = fc < fd                       # keep [a, d] else [c, b]
        a2 = torch.where(left, a, c)
        b2 = torch.where(left, d, b)
        # the surviving interior point becomes the far probe of the new
        # bracket; only the near probe is fresh
        c2 = torch.where(left, b2 - _GOLD * (b2 - a2), d)
        d2 = torch.where(left, c, a2 + _GOLD * (b2 - a2))
        f_new = fn(torch.where(left, c2, d2))
        fc, fd = torch.where(left, f_new, fd), torch.where(left, fc, f_new)
        a, b, c, d = a2, b2, c2, d2
    return 0.5 * (a + b)


def _sp2_v2_impl(sys: SystemParams, nu: Tensor, beta: Tensor,
                 rmin: Tensor) -> Tuple[Tensor, Tensor]:
    """Exact separable solve of SP2_v2 on a batched system: golden section
    per device inside a bisection on the budget multiplier. nu, beta, rmin
    (C, N). Returns (p, B)."""
    Btot = sys.bandwidth_total
    rmin = _clamp_rmin(sys, rmin)
    b_lo, b_hi = _budget_box(sys, rmin)

    def B_of_mu(mu):
        return _golden_argmin(
            lambda B: _h(sys, nu, beta, rmin, B) + mu * B, b_lo, b_hi)

    def sum_B(mu):
        return B_of_mu(mu).sum(-1, keepdim=True)

    # h is strictly decreasing => the cap binds; find the multiplier mu (A.15)
    def expand_cond(c):
        _, s, i = c
        return (s >= Btot)[:, 0] & (i < 200)

    def expand(c):
        mu_hi, _, i = c
        return mu_hi * 8.0, sum_B(mu_hi * 8.0), i + 1

    mu_hi0 = torch.full_like(Btot, 1e-12)
    i0 = torch.zeros(Btot.shape[0], dtype=torch.int32, device=Btot.device)
    mu_hi, _, _ = while_cells(expand_cond, expand,
                              (mu_hi0, sum_B(mu_hi0), i0))
    mu_lo = torch.zeros_like(mu_hi)
    for _ in range(_search_iters(b_lo.dtype, f32_iters=30)):
        mid = 0.5 * (mu_lo + mu_hi)
        over = sum_B(mid) > Btot
        mu_lo, mu_hi = torch.where(over, mid, mu_lo), \
            torch.where(over, mu_hi, mid)
    B_opt = B_of_mu(mu_hi)                  # the feasible end of the bracket

    # exact budget: scale surplus above the rate floors
    total = B_opt.sum(-1, keepdim=True)
    surplus = torch.clamp_min(B_opt - b_lo, 0.0)
    scale = 1.0 - (total - Btot) / torch.clamp_min(
        surplus.sum(-1, keepdim=True), 1e-30)
    B_shrunk = b_lo + surplus * torch.clamp(scale, 0.0, 1.0)
    B_opt = torch.where(total > Btot, B_shrunk,
                        B_opt * (Btot / torch.clamp_min(total, 1e-30)))
    return _p_star(sys, beta, rmin, B_opt), B_opt


# ----------------------------------------------------------------------------
# the default engine: exact direct solve of SP2
# ----------------------------------------------------------------------------

def direct_eval_counts(dtype: torch.dtype) -> int:
    """dE/dB evaluations per `solve_sp2_direct` dual search on the
    non-carried reference path (static): outer mu steps x inner bisection
    depth + the final polish + the mu_hi sizing evaluation."""
    outer = _search_iters(dtype, f32_iters=36)
    inner = _search_iters(dtype, f32_iters=24, f64_iters=48)
    return outer * inner + inner + 1


def _sp2_direct_impl(sys: SystemParams, rmin: Tensor,
                     carry_bracket: bool = True, newton: bool = True
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Exact SP2 solve. sys batched, rmin (C, N). Returns (p, B, ev): ev (C,)
    int32 counts the dE/dB evaluations of each cell's dual search.

    carry_bracket=True (default) carries the monotone-in-mu B bracket across
    the budget bisection and exits each inner search once its interval sums
    settle the budget predicate; newton=True (default) adds a warm-started
    safeguarded Newton step inside each carried search. carry_bracket=False
    is the reference path: every mu step re-bisects the full box at full
    depth (newton does not apply there)."""
    Btot = sys.bandwidth_total                          # (C, 1)
    rmin = _clamp_rmin(sys, rmin)
    b_lo, b_hi = _budget_box(sys, rmin)
    inner = _search_iters(b_lo.dtype, f32_iters=24, f64_iters=48)
    # reference per-lane precision: `inner` halvings of the full box
    w_stop = (b_hi - b_lo) * (2.0 ** -inner)
    tiny = torch.finfo(b_lo.dtype).tiny

    def bisect_step(mu, lo, hi):
        # one sign-bisection step on the convex phi(B) = E(B) + mu B
        mid = 0.5 * (lo + hi)
        pos = _denergy_dB(sys, rmin, mid) + mu >= 0.0
        return torch.where(pos, lo, mid), torch.where(pos, mid, hi)

    def undecided(lo, hi, it, decide: bool):
        run = ((hi - lo) > w_stop).any(-1) & (it < inner)
        if decide:
            sure = (hi.sum(-1, keepdim=True) < Btot) \
                | (lo.sum(-1, keepdim=True) > Btot)
            run = run & ~sure[:, 0]
        return run

    def iters0():
        return torch.zeros(b_lo.shape[0], dtype=torch.int32,
                           device=b_lo.device)

    def search_B_newton(mu, lo, hi, x, ev, decide: bool):
        # rtsafe-style safeguarded Newton on psi(B) = dE/dB(B) + mu, with
        # the sign-bisection as the fallback whenever the Newton candidate
        # leaves the bracket; a lane whose accepted step falls below
        # w_stop / 8 collapses its bracket onto the iterate
        def body(c):
            lo, hi, x, it = c
            psi = _denergy_dB(sys, rmin, x) + mu
            dpsi = torch.clamp_min(_denergy2_dB2(sys, rmin, x), tiny)
            pos = psi >= 0.0
            lo2 = torch.where(pos, lo, x)
            hi2 = torch.where(pos, x, hi)
            xn = x - psi / dpsi
            good = (xn > lo2) & (xn < hi2)
            x2 = torch.where(good, xn, 0.5 * (lo2 + hi2))
            conv = torch.abs(x2 - x) <= 0.125 * w_stop
            return (torch.where(conv, x2, lo2), torch.where(conv, x2, hi2),
                    x2, it + 1)

        lo, hi, x, it = while_cells(
            lambda c: undecided(c[0], c[1], c[3], decide), body,
            (lo, hi, torch.minimum(torch.maximum(x, lo), hi), iters0()))
        return lo, hi, x, ev + it

    def search_B(mu, lo, hi, ev, decide: bool):
        # carried-bracket bisection: stop at the reference precision or,
        # with `decide`, once the interval sums settle the budget predicate
        def body(c):
            lo, hi, it = c
            lo, hi = bisect_step(mu, lo, hi)
            return lo, hi, it + 1

        lo, hi, it = while_cells(
            lambda c: undecided(c[0], c[1], c[2], decide), body,
            (lo, hi, iters0()))
        return lo, hi, ev + it

    def bisect_B(mu):
        # the reference path's fixed-depth search from the full box
        lo, hi = b_lo, b_hi
        for _ in range(inner):
            lo, hi = bisect_step(mu, lo, hi)
        return lo, hi

    # at mu_hi = max_n -E_n'(b_lo) every device's phi' is nonnegative on
    # the whole box, so B(mu_hi) == b_lo; padded lanes are left out
    neg_slope = -_denergy_dB(sys, rmin, b_lo)
    if sys.active is not None:
        neg_slope = torch.where(sys.active, neg_slope,
                                torch.zeros((), dtype=b_lo.dtype,
                                            device=b_lo.device))
    mu_hi = torch.clamp_min(neg_slope.amax(-1, keepdim=True), 1e-30) \
        * (1.0 + 1e-3)
    outer = _search_iters(b_lo.dtype, f32_iters=36)
    mu_lo = torch.zeros_like(mu_hi)
    # the mu_hi sizing evaluation counts as one
    ev = iters0() + 1

    if carry_bracket:
        Blo, Bhi, Bx = b_lo, b_hi, 0.5 * (b_lo + b_hi)
        for _ in range(outer):
            mid = 0.5 * (mu_lo + mu_hi)
            if newton:
                lo2, hi2, Bx, ev = search_B_newton(mid, Blo, Bhi, Bx, ev,
                                                   decide=True)
            else:
                lo2, hi2, ev = search_B(mid, Blo, Bhi, ev, decide=True)
            over = (0.5 * (lo2 + hi2)).sum(-1, keepdim=True) > Btot
            mu_lo = torch.where(over, mid, mu_lo)
            mu_hi = torch.where(over, mu_hi, mid)
            Blo = torch.where(over, Blo, lo2)    # mu ceiling fell: floor up
            Bhi = torch.where(over, hi2, Bhi)    # mu floor rose: ceiling down
        if newton:
            lo_f, hi_f, _, ev = search_B_newton(mu_hi, Blo, Bhi, Bx, ev,
                                                decide=False)
        else:
            lo_f, hi_f, ev = search_B(mu_hi, Blo, Bhi, ev, decide=False)
    else:
        for _ in range(outer):
            mid = 0.5 * (mu_lo + mu_hi)
            blo, bhi = bisect_B(mid)
            over = (0.5 * (blo + bhi)).sum(-1, keepdim=True) > Btot
            mu_lo = torch.where(over, mid, mu_lo)
            mu_hi = torch.where(over, mu_hi, mid)
        lo_f, hi_f = bisect_B(mu_hi)
        ev = ev + outer * inner + inner
    B_opt = 0.5 * (lo_f + hi_f)

    total = B_opt.sum(-1, keepdim=True)
    surplus = torch.clamp_min(B_opt - b_lo, 0.0)
    scale = 1.0 - (total - Btot) / torch.clamp_min(
        surplus.sum(-1, keepdim=True), 1e-30)
    B_opt = torch.where(total > Btot,
                        b_lo + surplus * torch.clamp(scale, 0.0, 1.0), B_opt)
    p_opt = torch.minimum(torch.maximum(_p_rate(sys, rmin, B_opt), sys.p_min),
                          sys.p_max)
    return p_opt, B_opt, ev


# ----------------------------------------------------------------------------
# public entries: one cell ((N,) tensors) or a stack ((C, N))
# ----------------------------------------------------------------------------

def _like(sys: SystemParams, *xs: Tensor):
    """Outputs in the caller's layout: one cell's come back as (N,)."""
    return xs if sys.gain.ndim == 2 else tuple(x[0] for x in xs)


def solve_sp2_direct(sys: SystemParams, rmin: Tensor,
                     carry_bracket: bool = True,
                     newton: bool = True) -> Tuple[Tensor, Tensor]:
    """Globally exact SP2 solve via the boundary-power reformulation ->
    (p, B). carry_bracket / newton select the accelerated search (default)
    or its oracles: carry_bracket=False re-bisects the full box at every
    mu step, newton=False keeps the carried bracket without Newton."""
    b, (rmin,) = _cells_view(sys, rmin)
    p, B, _ = _sp2_direct_impl(b, rmin, carry_bracket, newton)
    return _like(sys, p, B)


def solve_sp2_v2(sys: SystemParams, w: Weights, nu: Tensor, beta: Tensor,
                 rmin: Tensor) -> Tuple[Tensor, Tensor]:
    """Exact solve of SP2_v2 via separable waterfilling -> (p, B)."""
    b, (nu, beta, rmin) = _cells_view(sys, nu, beta, rmin)
    return _like(sys, *_sp2_v2_impl(b, nu, beta, rmin))


# ----------------------------------------------------------------------------
# the paper-literal Appendix-D path: Lambert-W dual + Theorem 2
# ----------------------------------------------------------------------------

def _thm2_j(sys: SystemParams, nu: Tensor) -> Tensor:
    """The Lambert-W dual's per-device j_n = nu_n d_n N0 / g_n, (C, N).
    Padded lanes (j = 0: zero bits) are parked at max(j), so that the
    bracket sizing's min/max only see real devices; their rmin is 0, so
    their g'(mu) term is exactly 0."""
    j = nu * sys.bits * sys.noise_psd / sys.gain
    if sys.active is not None:
        j = torch.where(sys.active, j, j.amax(-1, keepdim=True))
    return j


def _thm2_bracket(sys: SystemParams, j: Tensor, rmin: Tensor
                  ) -> Tuple[Tensor, Tensor]:
    """The first sweep's multiplier range [lo, hi] per cell, (C, 1) each.

    g'(mu) is strictly decreasing; mu -> 0+ gives W -> -1 (g' -> +inf).
    For mu >> j, W + 1 ~ ln(mu/j), so the root satisfies
    ln(mu*/j) ~ sum(rmin) ln2 / B_total; hi is sized from that estimate
    (+10 nats for the -lnln(z) slack), capped so that hi and the kernel's
    ratio q = mu/j stay finite in the dtype the sweep computes in, which is
    the input dtype."""
    Btot = sys.bandwidth_total
    lo = torch.full_like(Btot, 1e-30)
    base = 2.0 * j.amax(-1, keepdim=True) + 1.0
    nats = rmin.sum(-1, keepdim=True) * _LN2 / torch.clamp_min(Btot, 1e-30) \
        + 10.0
    logmax = 0.9 * math.log(torch.finfo(j.dtype).max)
    cap = logmax + torch.clamp_max(torch.log(j.amin(-1, keepdim=True)), 0.0) \
        - torch.log(base)
    return lo, base * torch.exp(torch.minimum(nats, cap))


def _thm2_dual_mu(sys: SystemParams, j: Tensor, rmin: Tensor,
                  n_mu: int = 128, refine: int = 3) -> Tensor:
    """Root of g'(mu) (A.23) per cell, (C, 1), by a batched grid sweep
    through the `waterfill_gprime` kernel: each of the 1 + refine rounds
    evaluates n_mu candidate multipliers of every cell in one launch and
    re-grids geometrically inside the sign-change bracket; a secant step
    finishes. No host read."""
    lo, hi = _thm2_bracket(sys, j, rmin)
    j, rmin = j.contiguous(), rmin.contiguous()
    B_total = sys.bandwidth_total.reshape(-1).contiguous()
    index = torch.arange(n_mu, device=j.device)
    for _ in range(1 + refine):
        grid = _geomspace(lo, hi, n_mu).contiguous()
        g = kops.waterfill_gprime(grid, j, rmin, B_total)
        # first negative g', as the reference's argmax over (g < 0)
        first = torch.where(g < 0.0, index, n_mu).amin(-1, keepdim=True)
        idx = torch.where(first == n_mu, n_mu - 1, torch.clamp_min(first, 1))
        lo, hi = grid.gather(-1, idx - 1), grid.gather(-1, idx)
        g_lo, g_hi = g.gather(-1, idx - 1), g.gather(-1, idx)
    # secant interpolation on the final bracket
    t = torch.clamp(g_lo / torch.clamp_min(g_lo - g_hi, 1e-30), 0.0, 1.0)
    return lo + t * (hi - lo)


def _thm2_impl(sys: SystemParams, nu: Tensor, beta: Tensor, rmin: Tensor
               ) -> Tuple[Tensor, Tensor]:
    """The Appendix-D construction on a batched system; (C, N) inputs."""
    rmin = _clamp_rmin(sys, rmin)
    g_lin, d, N0 = sys.gain, sys.bits, sys.noise_psd
    j = _thm2_j(sys, nu)
    mu = _thm2_dual_mu(sys, j, rmin)

    W = lambertw0((mu - j) / (math.e * j))
    a_val = torch.where(W.abs() > 1e-12,
                        (mu - j) * _LN2 / torch.where(W.abs() < 1e-12, 1.0, W),
                        math.e * j * _LN2)              # (A.22) numerator
    tau = torch.clamp_min(a_val - nu * beta, 0.0)
    a = nu * beta + tau
    # padded lanes have d = 0: the guard keeps Lam finite, so B_opt = 0 and
    # p clips to p_min; real devices sit many orders above tiny
    denom = torch.clamp_min(N0 * d * nu * _LN2, torch.finfo(rmin.dtype).tiny)
    Lam = torch.clamp_min(a * g_lin / denom, 1.0 + 1e-12)
    B_opt = rmin / log2(Lam)                            # Theorem 2, tight branch
    total = B_opt.sum(-1, keepdim=True)
    Btot = sys.bandwidth_total
    B_opt = torch.where(total > Btot,
                        B_opt * (Btot / torch.clamp_min(total, 1e-30)), B_opt)
    p_opt = torch.minimum(torch.maximum((Lam - 1.0) * N0 * B_opt / g_lin,
                                        sys.p_min), sys.p_max)
    return p_opt, B_opt


def solve_sp2_v2_thm2(sys: SystemParams, w: Weights, nu: Tensor,
                      beta: Tensor, rmin: Tensor) -> Tuple[Tensor, Tensor]:
    """Paper-literal Appendix-D path: Lambert-W dual (A.22/A.23) + Theorem
    2 -> (p, B). Exact when every device's rate constraint is tight. The
    dual search is 1 + 3 launches of `waterfill_gprime` for all cells."""
    b, (nu, beta, rmin) = _cells_view(sys, nu, beta, rmin)
    return _like(sys, *_thm2_impl(b, nu, beta, rmin))


# ----------------------------------------------------------------------------
# Outer Newton-like iteration (Algorithm 1)
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class SP2Result:
    """Algorithm 1's result: (N,) / (C, N) tensors; `iters` and `residual`
    are an int and a float for one cell, (C,) tensors for a stack."""
    power: Tensor
    bandwidth: Tensor
    nu: Tensor
    beta: Tensor
    iters: Union[int, Tensor]
    residual: Union[float, Tensor]


def _phi_norm(sys: SystemParams, w1: Tensor, p: Tensor, B: Tensor,
              beta: Tensor, nu: Tensor) -> Tensor:
    """Norm of the KKT residual (eqs. 24-25) per cell, (C,)."""
    rate_ = G(sys, p, B)
    phi1 = -p * sys.bits + beta * rate_            # eq. (24)
    phi2 = -w1 * sys.global_rounds + nu * rate_    # eq. (25)
    phi = torch.cat([phi1, phi2], -1)
    if sys.active is not None:   # padded lanes have no KKT residual
        phi = torch.where(torch.cat([sys.active, sys.active], -1), phi,
                          torch.zeros((), dtype=phi.dtype, device=phi.device))
    return torch.sqrt((phi * phi).sum(-1))


def _sp2_jong_core(sys: SystemParams, w1: Tensor, rmin: Tensor, p0: Tensor,
                   B0: Tensor, max_iters: int, xi=0.5, eps=0.01, tol=1e-9,
                   damping=0.5):
    """Algorithm 1 on a batched system: w1 (C, 1), rmin / p0 / B0 (C, N).
    Returns (p, B, nu, beta, iters (C,), residual (C,))."""
    C = p0.shape[0]
    rate0 = torch.clamp_min(G(sys, p0, B0), 1e-9)
    nu0 = w1 * sys.global_rounds / rate0           # step 2
    beta0 = p0 * sys.bits / rate0
    res0 = _phi_norm(sys, w1, p0, B0, beta0, nu0)
    root_n = math.sqrt(sys.n) if sys.active is None \
        else torch.sqrt(sys.active.to(p0.dtype).sum(-1, keepdim=True))
    bp = sys.bits * sys.p_max
    scale = torch.clamp_min(torch.sqrt((bp * bp).sum(-1, keepdim=True))
                            + w1 * sys.global_rounds * root_n, 1.0)[:, 0]

    def cond(c):
        it, done = c[4], c[6]
        return ~done & (it < max_iters)

    def body(c):
        p, B, beta, nu, it, _, _ = c
        p_new, B_new = _sp2_v2_impl(sys, nu, beta, rmin)  # step 4
        p = damping * p + (1.0 - damping) * p_new
        B = damping * B + (1.0 - damping) * B_new
        rate_ = torch.clamp_min(G(sys, p, B), 1e-9)
        sigma1 = p * sys.bits / rate_ - beta          # eq. (29)
        sigma2 = w1 * sys.global_rounds / rate_ - nu
        # Algorithm 1 terminates when phi -> 0 at the freshly solved (p, B)
        res = _phi_norm(sys, w1, p, B, beta, nu)
        done = res <= tol * scale

        def bt_cond(s):                               # backtracking rule (28)
            _, found, i = s
            return ~found & (i < 30)

        def bt(s):
            step, _, i = s
            cand = _phi_norm(sys, w1, p, B, beta + step * sigma1,
                             nu + step * sigma2)
            ok = cand <= (1.0 - eps * step[:, 0]) * res
            return torch.where(ok[:, None], step, step * xi), ok, i + 1

        # seeding found=done skips the line search when the outer loop is
        # about to terminate (the duals are frozen below anyway)
        step, _, _ = while_cells(bt_cond, bt, (
            torch.ones((C, 1), dtype=p.dtype, device=p.device), done,
            torch.zeros(C, dtype=torch.int32, device=p.device)))
        beta = torch.where(done[:, None], beta, beta + step * sigma1)  # (30)
        nu = torch.where(done[:, None], nu, nu + step * sigma2)
        return p, B, beta, nu, it + 1, res, done

    it0 = torch.zeros(C, dtype=torch.int32, device=p0.device)
    done0 = torch.zeros(C, dtype=torch.bool, device=p0.device)
    p, B, beta, nu, it, res, _ = while_cells(
        cond, body, (p0, B0, beta0, nu0, it0, res0, done0))
    return p, B, nu, beta, it, res


def solve_sp2(sys: SystemParams, w: Weights, rmin: Tensor, p0: Tensor,
              B0: Tensor, max_iters: int = 30, xi: float = 0.5,
              eps: float = 0.01, tol: float = 1e-9,
              damping: float = 0.5) -> SP2Result:
    """Algorithm 1: Newton-like update of (beta, nu) around the SP2_v2
    solver. `damping` relaxes the (p, B) iterates between outer steps
    (SP2_v2's argmin is non-unique in the slack-rate regime, and the
    undamped fixed point oscillates between vertex allocations).
    `w.w1` may be a scalar or a per-cell (C,) / (C, 1) tensor."""
    b, (rmin, p0, B0) = _cells_view(sys, rmin, p0, B0)
    C = b.gain.shape[0]
    w1 = torch.as_tensor(w.w1, dtype=p0.dtype, device=p0.device)
    w1 = torch.broadcast_to(w1.reshape(-1, 1), (C, 1))
    p, B, nu, beta, it, res = _sp2_jong_core(b, w1, rmin, p0, B0, max_iters,
                                             xi, eps, tol, damping)
    p, B, nu, beta = _like(sys, p, B, nu, beta)
    if sys.gain.ndim == 1:
        return SP2Result(power=p, bandwidth=B, nu=nu, beta=beta,
                         iters=int(it[0]), residual=float(res[0]))
    return SP2Result(power=p, bandwidth=B, nu=nu, beta=beta, iters=it,
                     residual=res)
