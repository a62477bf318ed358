"""Subproblem 1 (paper §V-A, Appendix B): optimize (f, s, T) given (p, B).

Port of `repro/core/sp1.py`:

    min_{f, s_hat, T}  w1 Rg sum_n alpha_n s_hat^2 f^2 + w2 Rg T - rho sum_n A_n(s_hat)
    s.t. f in [fmin, fmax], s_hat in [s_lo, s_hi],
         q_n s_hat^2 / f + T_trans_n <= T

The KKT system (eqs. A.2-A.7) is solved by water-filling on the scalar map
T -> Sigma_n lambda_n(T), where lambda_n(T) inverts the decreasing
per-device makespan T_n(lambda). Two engines, as in the reference:

  * method="sweep" (default): every round evaluates Sigma_n lambda_n(T) for
    a geometric grid of candidate deadlines at once, narrows to the
    sign-change bracket, and the last bracket ends with a secant step. For
    the paper's LinearAccuracy each round is one pass of the
    `sp1_lambda_sum` kernel (closed-form lambda_n(T), all cells at once);
    any other concave accuracy model runs a 56-step lambda bisection per
    grid point instead (12 points x 4 rounds, no kernel).
  * method="bisect": the nested bisection (56 outer T steps x 56 inner
    lambda steps), the sweep's parity oracle.

`solve_sp1_fixed_T` is the deadline-constrained variant (Figs. 8-9): the
round deadline is fixed and each device picks its resolution by
enumeration. Every tensor carries the cell axis: (C, N) per device, (C, 1)
per cell. All loops here have fixed trip counts: no host read.
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops as kops
from ..kernels.sp1_sweep import N_CONSTS, _cbrt, lambda_of_T_linear
from .accuracy import AccuracyModel, LinearAccuracy
from .types import SYS_ARRAYS, SYS_SCALARS, SystemParams, Weights

Tensor = torch.Tensor

_INNER_ITERS = 56
_OUTER_ITERS = 56
_S_ITERS = 48

# `_SWEEP_ROUNDS` rounds of `_SWEEP_POINTS`-point grids shrink the bracket
# by (points-1)^rounds: 3 x 16 resolves the default [T_lo, T_hi] range to
# ~5e-3 relative before the secant step
_SWEEP_POINTS = 16
_SWEEP_ROUNDS = 3
# generic (non-linear) accuracy models pay a full lambda bisection per grid
# point: a coarser grid over one extra round (11^4 > 15^3)
_SWEEP_POINTS_GENERIC = 12
_SWEEP_ROUNDS_GENERIC = 4
_LOG10_E = math.log10(math.e)


def _coeffs(sys: SystemParams, w: Weights):
    """alpha_n (energy coeff, incl. w1 Rg) and q_n (cycles per s^2)."""
    q = sys.local_iters * sys.zeta * sys.cycles * sys.samples
    alpha = w.w1 * sys.global_rounds * sys.kappa * q
    return alpha, q


def _f_denom(sys: SystemParams, w: Weights, dtype: torch.dtype) -> Tensor:
    # dtype-aware guard: w1 == 0 (pure latency weighting) would make
    # cbrt(0/0) = NaN at lam = 0
    return torch.clamp_min(2.0 * w.w1 * sys.global_rounds * sys.kappa,
                           torch.finfo(dtype).tiny)


def _f_of_lambda(sys: SystemParams, w: Weights, lam: Tensor,
                 denom: Tensor | None = None) -> Tensor:
    """f*(lambda) = cbrt(lambda / (2 w1 Rg kappa)) clipped to the box;
    `denom` is `_f_denom`'s value where the caller has formed it."""
    if denom is None:
        denom = _f_denom(sys, w, lam.dtype)
    f_unc = _cbrt(lam / denom)
    return torch.minimum(torch.maximum(f_unc, sys.f_min), sys.f_max)


def _f_of_lambda_diff(sys: SystemParams, w: Weights, lam: Tensor) -> Tensor:
    """Value-identical (to an ulp) to `_f_of_lambda`, gradient-safe.

    The fused form cbrt(lam / denom) backpropagates -lam / denom^2, and
    denom = 2 w1 Rg kappa ~ 1e-27 underflows float32 when squared: every
    kappa / w1 gradient would become inf. The split cube root keeps the
    backward pass on the cube-root scale (denom^(4/3) ~ 1e-36, which float32
    holds), so the gradient path (`sp1_stationarity`, `repro_torch.diff`)
    uses this form."""
    f_unc = _cbrt(lam) / _cbrt(_f_denom(sys, w, lam.dtype))
    return torch.minimum(torch.maximum(f_unc, sys.f_min), sys.f_max)


def _s_of_lambda(sys: SystemParams, w: Weights, acc: AccuracyModel,
                 lam: Tensor) -> Tensor:
    """Solve s*(2 a f^2 + 2 lam q / f) = rho A'(s) on [s_lo, s_hi]: closed
    form for LinearAccuracy, a `_S_ITERS`-step bisection otherwise."""
    alpha, q = _coeffs(sys, w)
    f = _f_of_lambda(sys, w, lam)
    psi = 2.0 * alpha * (f * f) + 2.0 * lam * q / torch.clamp_min(f, 1e-9)
    return _s_of_psi(sys, w, acc, psi)


def _s_of_psi(sys: SystemParams, w: Weights, acc: AccuracyModel,
              psi: Tensor) -> Tensor:
    """The root s of s psi = rho A'(s) on [s_lo, s_hi]."""
    if isinstance(acc, LinearAccuracy):
        s_unc = w.rho * acc.slope / torch.clamp_min(
            psi, torch.finfo(psi.dtype).tiny)
        return torch.clamp(s_unc, sys.s_lo, sys.s_hi)

    def h(s):  # increasing in s (A concave)
        return s * psi - w.rho * acc.deriv(s)

    lo0 = torch.full_like(psi, sys.s_lo)
    hi0 = torch.full_like(psi, sys.s_hi)
    lo, hi = lo0, hi0
    for _ in range(_S_ITERS):
        mid = 0.5 * (lo + hi)
        pos = h(mid) > 0
        lo, hi = torch.where(pos, lo, mid), torch.where(pos, mid, hi)
    s = 0.5 * (lo + hi)
    s = torch.where(h(lo0) >= 0, sys.s_lo, s)
    return torch.where(h(hi0) <= 0, sys.s_hi, s)


def _makespan_fn(sys: SystemParams, w: Weights, acc: AccuracyModel,
                 tt: Tensor):
    """lam -> the per-device makespan q s*(lam)^2 / f*(lam) + tt, with the
    coefficients that do not depend on lam formed once (the same
    operations on the same operands as forming them per call)."""
    alpha, q = _coeffs(sys, w)
    denom = _f_denom(sys, w, tt.dtype)

    def makespan(lam: Tensor) -> Tensor:
        f = _f_of_lambda(sys, w, lam, denom)
        fs = torch.clamp_min(f, 1e-9)
        s = _s_of_psi(sys, w, acc, 2.0 * alpha * (f * f) + 2.0 * lam * q / fs)
        return q * (s * s) / fs + tt

    return makespan


def _makespan_of_lambda(sys: SystemParams, w: Weights, acc: AccuracyModel,
                        lam: Tensor, tt: Tensor) -> Tensor:
    return _makespan_fn(sys, w, acc, tt)(lam)


def _s_of_lambda_diff(sys: SystemParams, w: Weights, acc: AccuracyModel,
                      lam: Tensor, f: Tensor | None = None) -> Tensor:
    """Differentiable s*(lambda).

    For LinearAccuracy the closed form of `_s_of_lambda` is smooth and is
    returned as it is (psi floored at sqrt(tiny), not tiny: the division's
    backward squares the denominator, and tiny^2 underflows to 0, so a
    zero-coefficient padded lane with psi = 0 would give 0 * inf = NaN
    through the clip). For other models the fixed-step bisection has zero
    derivative, so the root is one Newton correction of the detached
    bisection result: equal in value to solver precision, with the exact
    implicit-function derivative. Lanes at the [s_lo, s_hi] box keep the
    bound.

    `f` optionally supplies a precomputed (lane-guarded) CPU frequency, for
    callers that must keep `_f_of_lambda`'s cube root away from lam = 0
    (infinite derivative); see `sp1_stationarity`."""
    alpha, q = _coeffs(sys, w)
    if f is None:
        f = _f_of_lambda_diff(sys, w, lam)
    psi = 2.0 * alpha * (f * f) + 2.0 * lam * q / torch.clamp_min(f, 1e-9)
    if isinstance(acc, LinearAccuracy):
        s_unc = w.rho * acc.slope / torch.clamp_min(
            psi, math.sqrt(torch.finfo(psi.dtype).tiny))
        return torch.clamp(s_unc, sys.s_lo, sys.s_hi)
    with torch.no_grad():
        s0 = _s_of_lambda(sys, w, acc, lam)
    h = s0 * psi - w.rho * acc.deriv(s0)          # traced residual at s0
    # h'(s) = psi - rho A''(s) > 0 (A concave), psi and A'' detached; A''
    # lane by lane from a backward pass of acc.deriv (it is elementwise)
    with torch.enable_grad():
        sr = s0.detach().requires_grad_()
        d2A, = torch.autograd.grad(acc.deriv(sr).sum(), sr, allow_unused=True)
    d2A = torch.zeros_like(s0) if d2A is None else d2A
    hp = torch.clamp_min(psi.detach() - w.rho * d2A,
                         torch.finfo(s0.dtype).tiny)
    eps = 1e-9
    interior = (s0 > sys.s_lo * (1.0 + eps)) & (s0 < sys.s_hi * (1.0 - eps))
    return torch.where(interior, s0 - h / hp, s0)


def sp1_stationarity(sys: SystemParams, w: Weights, acc: AccuracyModel,
                     lam: Tensor, T: Tensor, tt: Tensor,
                     mask: Tensor | None = None):
    """SP1 KKT residuals at a candidate dual point (lam, T).

    Returns (r_n, r_sum): r_n = M_n(lam_n) - T (per-device makespan
    equalization, meaningful where lam_n > 0), (C, N), and
    r_sum = sum_n lam_n - w2 Rg (the dual budget, eq. (18)), (C, 1). Both
    are differentiable in (lam, T, tt), the SystemParams leaves and the
    weights; the resolution inside M_n goes through `_s_of_lambda_diff`.
    `repro_torch.diff.implicit` corrects its detached bisection solve with
    one arrowhead Newton step on exactly these residuals.

    `mask` (optional, per device) restricts the system to the SP1 active
    set: lanes outside it (lam_n = 0 fast lanes and padded lanes) hold
    f = f_min with zero one-sided derivative, carry r_n = 0, and drop out of
    the dual budget sum. It is required whenever any lam_n = 0: the cube
    root has an infinite derivative at 0, and even a zero gradient times
    that is NaN."""
    _, q = _coeffs(sys, w)
    zero = torch.zeros((), dtype=lam.dtype, device=lam.device)
    if mask is None:
        f = _f_of_lambda_diff(sys, w, lam)
        s = _s_of_lambda_diff(sys, w, acc, lam, f=f)
        r_n = q * (s * s) / torch.clamp_min(f, 1e-9) + tt - T
        r_sum = lam.sum(-1, keepdim=True) - w.w2 * sys.global_rounds
        return r_n, r_sum
    lam_s = torch.where(mask, lam, torch.ones_like(lam))
    f = _f_of_lambda_diff(sys, w, lam_s)
    f = torch.where(mask, f, sys.f_min.to(f.dtype))
    s = _s_of_lambda_diff(sys, w, acc, lam_s, f=f)
    r_n = torch.where(mask, q * (s * s) / torch.clamp_min(f, 1e-9) + tt - T,
                      zero)
    r_sum = torch.where(mask, lam, zero).sum(-1, keepdim=True) \
        - w.w2 * sys.global_rounds
    return r_n, r_sum


def _lambda_of_T(sys: SystemParams, w: Weights, acc: AccuracyModel,
                 T: Tensor, tt: Tensor, lam_hi: Tensor) -> Tensor:
    """Per-device inverse of the decreasing map lambda -> T_n(lambda), by
    an `_INNER_ITERS`-step bisection; broadcasts over T and tt."""
    shape = torch.broadcast_shapes(T.shape, tt.shape)
    lo = torch.zeros(shape, dtype=tt.dtype, device=tt.device)
    hi = torch.broadcast_to(lam_hi, shape)
    makespan = _makespan_fn(sys, w, acc, tt)
    for _ in range(_INNER_ITERS):
        mid = 0.5 * (lo + hi)
        too_slow = makespan(mid) > T
        lo, hi = torch.where(too_slow, mid, lo), torch.where(too_slow, hi, mid)
    lam = 0.5 * (lo + hi)
    fast = makespan(torch.zeros_like(lam)) <= T
    return torch.where(fast, 0.0, lam)


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


def _grid_view(sys: SystemParams, w: Weights):
    """The batched system and weights with a candidate axis inserted after
    the cell axis: (C, 1, N) per device, (C, 1, 1) per cell, so that a
    (C, M, 1) grid of deadlines broadcasts against them."""
    arrays = {k: getattr(sys, k)[:, None] for k in SYS_ARRAYS + SYS_SCALARS}
    return (SystemParams(**arrays, resolutions=sys.resolutions),
            Weights(w.w1[:, None], w.w2[:, None], w.rho[:, None]))


def _bracket(S: Tensor, target: Tensor, grid: Tensor):
    """The sweep's sign-change bracket of S (C, M), nonincreasing along a
    grid: the first candidate under `target` and the one before it (the
    last pair when none is under). Returns (lo, hi, S_lo, S_hi), each
    (C, 1)."""
    n = S.shape[-1]
    index = torch.arange(n, device=S.device)
    first = torch.where(S < target, index, n).amin(-1, keepdim=True)
    idx = torch.where(first == n, n - 1, torch.clamp_min(first, 1))
    return (grid.gather(-1, idx - 1), grid.gather(-1, idx),
            S.gather(-1, idx - 1), S.gather(-1, idx))


def _solve_sp1_sweep_impl(sys: SystemParams, warr: Tensor,
                          acc: AccuracyModel, tt: Tensor):
    """Batched T-grid sweep engine (method="sweep"): sys batched, warr
    (C, 3) = (w1, max(w2, 1e-9), rho), tt (C, N). Returns (f, s, s_hat, T)
    with T (C, 1). LinearAccuracy runs each round as one `sp1_lambda_sum`
    launch; other models run a lambda bisection per grid point."""
    w = Weights(warr[:, 0:1], warr[:, 1:2], warr[:, 2:3])
    _, q = _coeffs(sys, w)
    lam_hi, target, T_lo, T_hi = _sp1_bounds(sys, w, q, tt)
    tiny = torch.finfo(T_lo.dtype).tiny

    linear = isinstance(acc, LinearAccuracy)
    if linear:
        consts = _sweep_consts(sys, w, acc, lam_hi)
        k3, rhok = consts[:, 0:1], consts[:, 1:2]

        def lam_sum(grid):
            return kops.sp1_lambda_sum(grid, q, tt, consts)

        n, rounds = _SWEEP_POINTS, _SWEEP_ROUNDS
    else:
        sys_g, w_g = _grid_view(sys, w)

        def lam_sum(grid):
            return _lambda_of_T(sys_g, w_g, acc, grid[:, :, None],
                                tt[:, None, :], lam_hi[:, None]).sum(-1)

        n, rounds = _SWEEP_POINTS_GENERIC, _SWEEP_ROUNDS_GENERIC

    lo, hi = T_lo, T_hi
    S_lo = S_hi = None
    for _ in range(rounds):
        grid = _geomspace(lo, hi, n)
        # Sigma lambda(T) is nonincreasing in T; bracket its target crossing
        lo, hi, S_lo, S_hi = _bracket(lam_sum(grid), target, grid)
    t = torch.clamp((S_lo - target) / torch.clamp_min(S_lo - S_hi, tiny),
                    0.0, 1.0)
    T = lo + t * (hi - lo)
    if linear:
        lam = lambda_of_T_linear(T, q, tt, k3, rhok, sys.f_min, sys.f_max,
                                 sys.s_lo, sys.s_hi, lam_hi)
    else:
        lam = _lambda_of_T(sys, w, acc, T, tt, lam_hi)
    return _finish_sp1(sys, w, acc, q, lam, tt, T)


def _solve_sp1_impl(sys: SystemParams, warr: Tensor, acc: AccuracyModel,
                    tt: Tensor):
    """Nested-bisection engine (method="bisect"), the sweep's parity
    oracle; same arguments and results as `_solve_sp1_sweep_impl`."""
    w = Weights(warr[:, 0:1], warr[:, 1:2], warr[:, 2:3])
    _, q = _coeffs(sys, w)
    lam_hi, target, lo, hi = _sp1_bounds(sys, w, q, tt)
    for _ in range(_OUTER_ITERS):
        mid = 0.5 * (lo + hi)
        lam = _lambda_of_T(sys, w, acc, mid, tt, lam_hi)
        more_time = lam.sum(-1, keepdim=True) > target   # raise T
        lo, hi = torch.where(more_time, mid, lo), \
            torch.where(more_time, hi, mid)
    T = 0.5 * (lo + hi)
    lam = _lambda_of_T(sys, w, acc, T, tt, lam_hi)
    return _finish_sp1(sys, w, acc, q, lam, tt, T)


_SP1_IMPLS = {"sweep": _solve_sp1_sweep_impl, "bisect": _solve_sp1_impl}


def dual_evals_per_iter(sp1_method: str, acc: AccuracyModel) -> int:
    """SP1 Sigma-lambda(T) dual evaluations one BCD iteration spends,
    counted at the candidate-deadline level (closed form for LinearAccuracy
    under "sweep", an `_INNER_ITERS` bisection otherwise); the +1 is the
    final lambda(T) inversion at the bracketing result."""
    if sp1_method == "sweep":
        if isinstance(acc, LinearAccuracy):
            return _SWEEP_POINTS * _SWEEP_ROUNDS + 1
        return _SWEEP_POINTS_GENERIC * _SWEEP_ROUNDS_GENERIC + 1
    if sp1_method == "bisect":
        return _OUTER_ITERS + 1
    raise ValueError(f"sp1_method must be sweep|bisect, got {sp1_method!r}")


def _cells_view(sys: SystemParams, *xs: Tensor):
    """The batched system and each per-device tensor as (C, N): the public
    entries take one cell's (N,) tensors or a stack's (C, N)."""
    b = sys.batched()
    return b, tuple(torch.broadcast_to(x, sys.gain.shape).reshape(
        b.gain.shape) for x in xs)


def _weights_rows(w: Weights, C: int, like: Tensor, floor_w2: bool):
    """(C, 3) rows (w1, w2, rho) from scalar or per-cell weights; w2 is
    floored at 1e-9 for the free-deadline engines, as the reference does."""
    cols = [torch.broadcast_to(torch.as_tensor(
        x, dtype=like.dtype, device=like.device).reshape(-1), (C,))
        for x in (w.w1, w.w2, w.rho)]
    if floor_w2:
        cols[1] = torch.clamp_min(cols[1], 1e-9)
    return torch.stack(cols, -1)


def solve_sp1(sys: SystemParams, w: Weights, acc: AccuracyModel,
              bandwidth: Tensor, power: Tensor, method: str = "sweep"):
    """Returns (f, s_discrete, s_hat, T) in the caller's layout: (N,)
    tensors and a 0-d T for one cell, (C, N) and (C,) for a stack. T is the
    per-round makespan consistent with the rounded resolution (SP2's
    r_min uses it). method: "sweep" (default) or "bisect"."""
    from .energy import rate

    if method not in _SP1_IMPLS:
        raise ValueError(f"method must be sweep|bisect, got {method!r}")
    b, (bandwidth, power) = _cells_view(sys, bandwidth, power)
    tt = b.bits / torch.clamp_min(rate(b, bandwidth, power), 1e-12)
    warr = _weights_rows(w, tt.shape[0], tt, floor_w2=True)
    f, s, s_hat, T = _SP1_IMPLS[method](b, warr, acc, tt)
    if sys.gain.ndim == 1:
        return f[0], s[0], s_hat[0], T[0, 0]
    return f, s, s_hat, T[:, 0]


def _solve_sp1_fixed_impl(sys: SystemParams, warr: Tensor,
                          acc: AccuracyModel, tt: Tensor, T_round: Tensor):
    """Deadline-constrained SP1 on a batched system, T_round (C, 1): per
    device and menu option the smallest feasible f (energy rises with f),
    then the option minimizing w1 Rg kappa q s^2 f^2 - rho A(s). Returns
    (f, s), each (C, N)."""
    w = Weights(warr[:, 0:1], warr[:, 1:2], warr[:, 2:3])
    alpha, q = _coeffs(sys, w)
    res = torch.as_tensor(sys.resolutions, dtype=tt.dtype, device=tt.device)
    budget = torch.clamp_min(T_round - tt, 1e-9)[..., None]   # (C, N, 1)
    f_req = q[..., None] * (res * res) / budget                 # (C, N, M)
    feas = f_req <= sys.f_max[..., None] * (1.0 + 1e-9)
    f_opt = torch.minimum(torch.maximum(f_req, sys.f_min[..., None]),
                          sys.f_max[..., None])
    obj = alpha[..., None] * (res * res) * (f_opt * f_opt) \
        - w.rho[..., None] * acc.value(res)
    obj = torch.where(feas, obj, torch.full((), float("inf"),
                                            dtype=obj.dtype,
                                            device=obj.device))
    pick = obj.argmin(-1, keepdim=True)
    return f_opt.gather(-1, pick)[..., 0], res[pick[..., 0]]


def solve_sp1_fixed_T(sys: SystemParams, w: Weights, acc: AccuracyModel,
                      bandwidth: Tensor, power: Tensor, T_round) -> tuple:
    """Deadline-constrained variant of the Fig. 8/9 comparisons: the round
    deadline is a hard constraint (no w2 T term) and s is picked exactly
    by enumeration of the menu. T_round is a scalar or a per-cell (C,)
    deadline. Returns (f, s) in the caller's layout."""
    from .energy import rate

    b, (bandwidth, power) = _cells_view(sys, bandwidth, power)
    tt = b.bits / torch.clamp_min(rate(b, bandwidth, power), 1e-12)
    C = tt.shape[0]
    warr = _weights_rows(w, C, tt, floor_w2=False)
    T = torch.broadcast_to(torch.as_tensor(
        T_round, dtype=tt.dtype, device=tt.device).reshape(-1, 1), (C, 1))
    f, s = _solve_sp1_fixed_impl(b, warr, acc, tt, T)
    return (f[0], s[0]) if sys.gain.ndim == 1 else (f, s)
