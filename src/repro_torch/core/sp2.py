"""Subproblem 2 (paper §V-B/C, Appendix D): optimize (p, B) given (f, s, T).

Port of `repro/core/sp2.py`, the default `direct` engine:

    min_{p,B} w1 Rg sum_n p_n d_n / G_n(p_n, B_n)
    s.t. sum B_n <= B, 0 <= B_n, pmin <= p_n <= pmax,
         G_n(p_n, B_n) >= r_n^min = d_n / (T - T_cmp_n)

The per-device energy E(p) = p d / G(p, B) is strictly increasing in p, so
the optimal power sits on the boundary p* = max(pmin, p_rate(B)); SP2
collapses to a separable convex program over B with one budget
constraint, solved exactly by a bisection on its multiplier mu around a
safeguarded Newton search for each device's B*(mu).

Every tensor carries the cell axis: (C, N) per device, (C, 1) per cell.
The data-dependent searches run as `loops.while_cells`, with the same
per-cell exits as the reference's `vmap` of `lax.while_loop`.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from .energy import log2
from .loops import while_cells
from .types import SystemParams

Tensor = torch.Tensor

_LN2 = math.log(2.0)


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


def _sp2_direct_impl(sys: SystemParams, rmin: Tensor
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """Exact SP2 solve on the reference's default path (carried bracket,
    Newton). sys batched, rmin (C, N). Returns (p, B, ev): ev (C,) int32
    counts the dE/dB evaluations of each cell's dual search."""
    Btot = sys.bandwidth_total                          # (C, 1)
    rmin = _clamp_rmin(sys, rmin)
    b_lo = _b_min(sys, rmin)
    b_lo, _ = _mask_box(sys, b_lo, b_lo)
    fit = torch.clamp_max(0.999 * Btot / torch.clamp_min(
        b_lo.sum(-1, keepdim=True), 1e-30), 1.0)
    b_lo = b_lo * fit          # infeasible deadline -> best-effort floors
    b_hi = torch.maximum(torch.broadcast_to(Btot, b_lo.shape), b_lo)
    b_lo, b_hi = _mask_box(sys, b_lo, b_hi)
    inner = _search_iters(b_lo.dtype, f32_iters=24, f64_iters=48)
    # reference per-lane precision: `inner` halvings of the full box
    w_stop = (b_hi - b_lo) * (2.0 ** -inner)
    tiny = torch.finfo(b_lo.dtype).tiny

    def search_B_newton(mu, lo, hi, x, ev, decide: bool):
        # rtsafe-style safeguarded Newton on psi(B) = dE/dB(B) + mu, with
        # the sign-bisection as the fallback whenever the Newton candidate
        # leaves the bracket; a lane whose accepted step falls below
        # w_stop / 8 collapses its bracket onto the iterate
        def cond(c):
            lo, hi, _, it = c
            run = ((hi - lo) > w_stop).any(-1) & (it < inner)
            if decide:
                sure = (hi.sum(-1, keepdim=True) < Btot) \
                    | (lo.sum(-1, keepdim=True) > Btot)
                run = run & ~sure[:, 0]
            return run

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

        it0 = torch.zeros(lo.shape[0], dtype=torch.int32, device=lo.device)
        lo, hi, x, it = while_cells(
            cond, body, (lo, hi, torch.minimum(torch.maximum(x, lo), hi), it0))
        return lo, hi, x, ev + it

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
    ev = torch.ones(b_lo.shape[0], dtype=torch.int32, device=b_lo.device)

    Blo, Bhi, Bx = b_lo, b_hi, 0.5 * (b_lo + b_hi)
    for _ in range(outer):
        mid = 0.5 * (mu_lo + mu_hi)
        lo2, hi2, Bx, ev = search_B_newton(mid, Blo, Bhi, Bx, ev, decide=True)
        over = (0.5 * (lo2 + hi2)).sum(-1, keepdim=True) > Btot
        mu_lo = torch.where(over, mid, mu_lo)
        mu_hi = torch.where(over, mu_hi, mid)
        Blo = torch.where(over, Blo, lo2)    # mu ceiling fell: floor up
        Bhi = torch.where(over, hi2, Bhi)    # mu floor rose: ceiling down
    lo_f, hi_f, _, ev = search_B_newton(mu_hi, Blo, Bhi, Bx, ev, decide=False)
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
