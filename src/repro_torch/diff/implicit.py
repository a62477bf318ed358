"""Implicit KKT gradients through the BCD fixed point (`core/bcd.py`).

Port of `repro/diff/implicit.py`. The forward pass is the BCD loop over
block-coordinate steps x -> Phi(x, theta), x = (B, p), where Phi is one
SP1 (f, s, T given transmission times) + SP2 (p, B given rate floors)
sweep and theta collects the differentiable data: the raw weight vector
(w1, w2, rho) and any float `SystemParams` leaves. Unrolling that loop
would be both expensive and wrong (the inner solves are fixed-step
bisections whose iterates have zero derivative), so the solved point is
differentiated implicitly:

* the fixed point is a `torch.autograd.Function`: its forward runs the
  port's `_allocate_impl` without a graph (on CUDA, where `sp1_lambda_sum`
  launches); its backward builds Phi's graph once at the fixed point and
  solves the adjoint system u = v + Phi_x^T u, by `adjoint_iters`
  applications of the one-step pullback (a truncated Neumann series), or
  with `adjoint_iters=0` exactly, by a dense solve of (I - Phi_x^T) u = v
  over each cell's 2N (B, p) unknowns; then it pulls u back through
  Phi_theta. The four metrics are four backward calls on one graph, and
  the Phi graph (and the dense Jacobian) is built on the first and reused.
* inside Phi every inner bisection (SP1's nested dual search, SP2's budget
  multiplier, the rate floor `_b_min`) runs detached and is followed by
  one Newton / arrowhead correction on the stationarity residuals
  (`core.sp1.sp1_stationarity`, `core.sp2.sp2_stationarity`): equal in
  value to solver precision, exact implicit-function derivative.

Cells are independent: one batched graph over the (C, N) stack stands in
for the reference's `vmap` over cells.

Subgradient conventions, as the reference's: the discrete resolution is
piecewise constant (zero gradient a.e.); box clips give one-sided zero
derivatives; the makespan max routes gradient to its argmax lanes; active
sets (lam_n > 0 in SP1, B_n above its rate floor in SP2) are frozen at the
solved point. At the saturated fixed points of this model family,
gradients w.r.t. the weights and the SP1-side leaves (kappa, cycles,
samples, local_iters, global_rounds, s_standard) track finite differences
of the full solve to ~1e-6; the channel-side leaves (gain, bits,
noise_psd, p_max, bandwidth_total) get the one-sided KKT derivative, a
descent direction rather than a certified sensitivity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..api.problem import Problem
from ..api.spec import SolverSpec
from ..core import energy as en
from ..core.accuracy import AccuracyModel, default_accuracy
from ..core.bcd import _allocate_impl, _init_carry_state, initial_allocation
from ..core.energy import rate as _rate
from ..core.sp1 import (_OUTER_ITERS, _coeffs, _f_of_lambda_diff,
                        _lambda_of_T, _s_of_lambda_diff, _sp1_bounds,
                        round_resolution, sp1_stationarity)
from ..core.sp2 import (_LN2, G, _b_min, _clamp_rmin, _denergy2_dB2,
                        _denergy_dB, _p_rate, _sp2_direct_impl, r_min)
from ..core.types import (SYS_ARRAYS, SYS_SCALARS, Allocation, SystemParams,
                          Weights)

Tensor = torch.Tensor

#: SystemParams leaves differentiated by default
DEFAULT_WRT = ("gain", "cycles", "bandwidth_total", "kappa")

#: metric order in the stacked values and gradient rows
METRICS = ("objective", "energy", "time", "accuracy")


def _with_pad_bandwidth(sys: SystemParams, B: Tensor) -> Tensor:
    """B with padded lanes' 0 replaced by the cell's whole budget, where
    the graph divides by N0 B (the rate, dE/dB). A pad lane carries no bits
    and is masked wherever it could count, so every value stays as it is;
    but at B = 0 the divisor N0 B ~ 4e-30 squares to 0 in float32 in the
    division's backward, and the pad lane's zero gradient becomes 0/0 =
    NaN (as it does in the reference in float32)."""
    if sys.active is None:
        return B
    return torch.where(sys.active, B, sys.bandwidth_total.to(B.dtype))


def _detached(sys: SystemParams) -> SystemParams:
    return sys.replace(**{k: getattr(sys, k).detach()
                          for k in SYS_ARRAYS + SYS_SCALARS})


# ---------------------------------------------------------------------------
# the differentiable one-step map Phi (SP1 + SP2, inner solves corrected)
# ---------------------------------------------------------------------------

def _sp1_diff(sys: SystemParams, warr: Tensor, acc: AccuracyModel,
              tt: Tensor):
    """Differentiable replica of the nested-bisection SP1 engine.

    The nested T / lambda bisection runs detached; the KKT point (lam, T)
    then takes one arrowhead Newton step on the traced `sp1_stationarity`
    residuals, which restores the exact implicit derivative of the dual
    water-filling system M_n(lam_n) = T (lam_n > 0), sum_n lam_n = w2 Rg.
    """
    # the BCD's w2 > 0 clamp keeps the dual target positive
    w = Weights(warr[:, 0:1], torch.clamp_min(warr[:, 1:2], 1e-9),
                warr[:, 2:3])
    sys0 = _detached(sys)
    w0 = Weights(w.w1.detach(), w.w2.detach(), w.rho.detach())
    tt0 = tt.detach()
    with torch.no_grad():
        _, q0 = _coeffs(sys0, w0)
        lam_hi, target0, lo, hi = _sp1_bounds(sys0, w0, q0, tt0)
        for _ in range(_OUTER_ITERS):
            mid = 0.5 * (lo + hi)
            lam = _lambda_of_T(sys0, w0, acc, mid, tt0, lam_hi)
            more_time = lam.sum(-1, keepdim=True) > target0
            lo, hi = torch.where(more_time, mid, lo), \
                torch.where(more_time, hi, mid)
        T0 = 0.5 * (lo + hi)
        lam0 = _lambda_of_T(sys0, w0, acc, T0, tt0, lam_hi)

    # SP1 active set: fast lanes snap lam = 0 and padded lanes are inactive;
    # both stay out of every traced recomputation (the cube root's
    # derivative is infinite at lam = 0 and would turn zero gradients NaN)
    eff = lam0 > 0.0
    if sys.active is not None:
        eff = eff & sys.active

    # traced residuals at the detached KKT point ...
    r_n, r_sum = sp1_stationarity(sys, w, acc, lam0, T0, tt, mask=eff)
    # ... and the per-device makespan slope M'_n < 0 at that point (the map
    # is lane-separable, so a backward pass of the sum is its diagonal)
    with torch.enable_grad():
        lr = lam0.detach().requires_grad_()
        mk = sp1_stationarity(sys0, w0, acc, lr, T0, tt0, mask=eff)[0]
        dM, = torch.autograd.grad(mk.sum(), lr)

    zero = torch.zeros((), dtype=lam0.dtype, device=lam0.device)
    # lanes holding the makespan equalization with a responsive slope take
    # the arrowhead correction; the rest keep lam = 0
    act = eff & (dM < -1e-30)
    inv = torch.where(act, 1.0 / torch.where(act, dM, -1.0), zero)
    denom = inv.sum(-1, keepdim=True)
    ok = denom.abs() > 1e-30
    # arrowhead solve of the linearized system:
    #   M'_n dlam_n - dT = -r_n  (active n),   sum dlam = -r_sum
    dT = torch.where(
        ok, ((torch.where(act, r_n, zero) * inv).sum(-1, keepdim=True)
             - r_sum) / torch.where(ok, denom, 1.0),
        torch.zeros_like(T0))
    dlam = torch.where(act, (dT - r_n) * inv, zero)
    lam = lam0 + dlam
    T = T0 + dT

    # guarded primal recovery: active lanes follow the smooth closed forms,
    # lam = 0 lanes hold the one-sided f = f_min and keep s*'s smooth
    # dependence through psi
    lam_s = torch.where(eff, lam, torch.ones_like(lam))
    f = _f_of_lambda_diff(sys, w, lam_s)
    f = torch.where(eff, f, sys.f_min.to(f.dtype))
    s_hat = _s_of_lambda_diff(sys, w, acc, lam, f=f)
    # the discrete snap is piecewise constant in theta: detached (zero a.e.)
    s_disc = round_resolution(sys0, s_hat.detach())
    _, q = _coeffs(sys, w)
    T_out = (q * (s_disc * s_disc) / torch.clamp_min(f, 1e-9)
             + tt).amax(-1, keepdim=True)
    return f, s_disc, s_hat, torch.maximum(T, T_out)


def _sp2_diff(sys: SystemParams, rmin: Tensor) -> Tuple[Tensor, Tensor]:
    """Differentiable replica of `core.sp2._sp2_direct_impl`.

    The forward SP2 solve runs detached, and the replica is built around
    its output B0, so that it equals the forward at the linearization
    point (the adjoint solve amplifies any base-point mismatch along the
    budget-coupling direction). Lane by lane at the frozen solved point:

    * rate-floor lanes (B0 = b_min, the p_max kink): B follows the traced
      root of G(p_max, b) = rmin (detached bisection + one Newton step);
    * fit-floor lanes (B0 at the scaled floor b_lo = fit * b_min): B
      follows the traced floor;
    * every other lane: B follows the root of dE_n/dB + mu_n = 0 by one
      Newton step on the frozen branch, mu_n = c_n * mu_hi with c_n frozen
      (the carried-bracket search leaves each lane a slightly different
      dyadic fraction of the traced bracket ceiling mu_hi).

    The forward's exact-budget projection is applied in delta form over
    the lanes' frozen surplus shares, which keeps sum B = B_total a traced
    identity without dividing by the tiny traced surplus mass.
    """
    sys0 = _detached(sys)
    rmin_c = _clamp_rmin(sys, rmin)
    rmin0 = rmin_c.detach()
    with torch.no_grad():
        _, B0, _ = _sp2_direct_impl(sys0, rmin.detach(), True, True)
        b0 = _b_min(sys0, rmin0)
    dtype, device = B0.dtype, B0.device
    zero = torch.zeros((), dtype=dtype, device=device)

    # differentiable rate floor b_min: Newton-correct the detached
    # bisection root of G(p_max, b) = rmin
    t = sys0.gain * sys0.p_max / (sys0.noise_psd * torch.clamp_min(b0, 1e-12))
    GB = torch.clamp_min((torch.log1p(t) - t / (1.0 + t)) / _LN2, 1e-30)
    pmax_b = torch.broadcast_to(sys.p_max, B0.shape)
    b_min = b0 - (G(sys, pmax_b, b0) - rmin_c) / GB
    active = sys.active if sys.active is not None \
        else torch.ones(B0.shape, dtype=torch.bool, device=device)
    b_min = torch.where(active, b_min, zero)
    b_min0 = b_min.detach()
    # ... then the forward's best-effort fit scaling of the box
    fit = torch.clamp_max(0.999 * sys.bandwidth_total / torch.clamp_min(
        b_min.sum(-1, keepdim=True), 1e-30), 1.0)
    b_lo = b_min * fit
    b_lo0 = b_lo.detach()

    # frozen lane classification at the solved point
    atkink = active & ((B0 - b_min0).abs()
                       <= 1e-6 * torch.clamp_min(b_min0, 1e-30))
    atfloor = active & ~atkink & (B0 <= b_lo0 * (1.0 + 1e-6))
    interior = active & ~atkink & ~atfloor

    # per-lane effective multiplier mu_n = c_n * mu_hi: the frozen fraction
    # from the forward's own slope at B0, the traced ceiling from the
    # forward's mu_hi sizing rule
    # (pad lanes are evaluated at a safe bandwidth and masked: see
    # `_with_pad_bandwidth`)
    neg_slope = torch.where(active, -_denergy_dB(
        sys, rmin_c, _with_pad_bandwidth(sys, b_lo)), zero)
    mu_hi = torch.clamp_min(neg_slope.amax(-1, keepdim=True), 1e-30) \
        * (1.0 + 1e-3)
    mu_lane0 = torch.clamp_min(-_denergy_dB(sys0, rmin0, B0), 0.0)
    mu_eff = (mu_lane0 / mu_hi.detach()).detach() * mu_hi

    # one Newton step of root tracking on the frozen smooth branch:
    # g_n = dE/dB(B0) + mu_eff is zero at the base point
    g_n = _denergy_dB(sys, rmin_c, _with_pad_bandwidth(sys, B0)) + mu_eff
    E2 = torch.clamp_min(_denergy2_dB2(sys0, rmin0, B0),
                         torch.finfo(dtype).tiny)
    # off the interior lanes E2 may be NaN (a pad lane's t^2 overflows
    # float32); keep it out of the division's backward there
    B_int = B0 - g_n / torch.where(interior, E2, 1.0)
    B = torch.where(atkink, b_min,
                    torch.where(atfloor, b_lo,
                                torch.where(interior, B_int, zero)))
    # exact-budget projection, delta form with frozen surplus shares
    surplus0 = torch.where(active, torch.clamp_min(B0 - b_lo0, 0.0), zero)
    wgt = surplus0 / torch.clamp_min(surplus0.sum(-1, keepdim=True), 1e-30)
    B = B + wgt * (sys.bandwidth_total - B.sum(-1, keepdim=True))
    B = torch.where(active, B, zero)
    p = torch.minimum(torch.maximum(_p_rate(sys, rmin_c, B), sys.p_min),
                      sys.p_max)
    return B, p


def _phi_step(x, sys: SystemParams, warr: Tensor, acc: AccuracyModel):
    """One differentiable BCD step (mirrors `bcd._allocate_impl`'s step).
    Returns the next (B, p) and the SP1 outputs (f, s, s_hat, T)."""
    B, p = x
    tt = sys.bits / torch.clamp_min(
        _rate(sys, _with_pad_bandwidth(sys, B), p), 1e-12)
    f, s_disc, s_hat, T = _sp1_diff(sys, warr, acc, tt)
    rmin = r_min(sys, f, s_disc, T)
    B2, p2 = _sp2_diff(sys, rmin)
    return (B2, p2), (f, s_disc, s_hat, T)


def _step_metrics(x, sys: SystemParams, warr: Tensor, acc: AccuracyModel):
    """(C, 4) (objective, energy, time, accuracy) and the realized
    Allocation, through one differentiable BCD step at the fixed point."""
    (B2, p2), (f, s_disc, s_hat, T) = _phi_step(x, sys, warr, acc)
    alloc = Allocation(bandwidth=B2, power=p2, freq=f, resolution=s_disc,
                       s_relaxed=s_hat, T=T)
    safe = dataclasses.replace(alloc,
                               bandwidth=_with_pad_bandwidth(sys, B2))
    E = en.total_energy(sys, safe)[:, 0]
    Tt = en.total_time(sys, safe)[:, 0]
    A = en.total_accuracy(acc, alloc, sys.active)[:, 0]
    obj = warr[:, 0] * E + warr[:, 1] * Tt - warr[:, 2] * A
    return torch.stack([obj, E, Tt, A], -1), alloc


# ---------------------------------------------------------------------------
# the fixed point as an autograd Function
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Solver:
    """What the fixed point needs besides its tensor inputs."""
    sys: SystemParams            # batched
    wrt: Tuple[str, ...]
    acc: AccuracyModel
    spec: SolverSpec
    state0: tuple
    adjoint_iters: int

    def build(self, lv) -> SystemParams:
        return self.sys.replace(**dict(zip(self.wrt, lv)))

    def phi(self, x, lv, warr):
        return _phi_step(x, self.build(lv), warr, self.acc)[0]


class _FixedPoint(torch.autograd.Function):
    """(B, p) = the BCD fixed point of the problem with leaves `lv` and
    normalized weights `warr`; backward by the implicit function theorem."""

    @staticmethod
    def forward(ctx, solver: _Solver, warr: Tensor, *lv: Tensor):
        s = solver.spec
        out = _allocate_impl(solver.build(lv), warr, solver.acc,
                             solver.state0, s.max_iters, s.tol, s.sp1_method,
                             s.sp2_method, s.sp2_iters)
        ctx.solver, ctx.graph, ctx.jac = solver, None, None
        ctx.save_for_backward(out[0], out[1], warr, *lv)
        return out[0], out[1]

    @staticmethod
    def backward(ctx, vB: Optional[Tensor], vp: Optional[Tensor]):
        B, p, warr, *lv = ctx.saved_tensors
        v = (torch.zeros_like(B) if vB is None else vB,
             torch.zeros_like(p) if vp is None else vp)
        with torch.enable_grad():
            if ctx.graph is None:   # Phi's graph at the fixed point, once
                x = (B.detach().requires_grad_(),
                     p.detach().requires_grad_())
                w_ = warr.detach().requires_grad_()
                l_ = [t.detach().requires_grad_() for t in lv]
                ctx.graph = (x, w_, l_, ctx.solver.phi(x, l_, w_))
            x, w_, l_, out = ctx.graph

            def pull_x(u):
                return torch.autograd.grad(out, x, grad_outputs=u,
                                           retain_graph=True,
                                           allow_unused=True)

            if ctx.solver.adjoint_iters > 0:
                # Neumann adjoint: u = sum_k (Phi_x^T)^k v solves
                # u = v + Phi_x^T u
                u = v
                for _ in range(ctx.solver.adjoint_iters):
                    g = pull_x(u)
                    u = tuple(vi if gi is None else vi + gi
                              for vi, gi in zip(v, g))
            else:
                u = _dense_adjoint(ctx, x, pull_x, v)
            theta = [w_, *l_]
            grads = torch.autograd.grad(out, theta, grad_outputs=u,
                                        retain_graph=True, allow_unused=True)
        return (None, *(torch.zeros_like(t) if g is None else g
                        for t, g in zip(theta, grads)))


def _dense_adjoint(ctx, x, pull_x, v):
    """Solve (I - Phi_x^T) u = v exactly per cell over the 2N (B, p)
    unknowns. Row j of each cell's Jacobian is the pullback of the j-th
    unit cotangent (the cells share it: they are independent). The budget
    coupling puts an eigenvalue of Phi_x near 1, which stalls a Neumann
    series but is well posed for a dense solve."""
    B = x[0]
    C, N = B.shape
    if ctx.jac is None:
        rows = []
        for j in range(2 * N):
            e = torch.zeros((C, 2 * N), dtype=B.dtype, device=B.device)
            e[:, j] = 1.0
            g = pull_x((e[:, :N], e[:, N:]))
            rows.append(torch.cat([torch.zeros_like(B) if gi is None else gi
                                   for gi in g], -1))
        ctx.jac = torch.stack(rows, 1)            # (C, 2N out, 2N in)
    eye = torch.eye(2 * N, dtype=B.dtype, device=B.device)
    u = torch.linalg.solve(eye - ctx.jac.transpose(-1, -2),
                           torch.cat(v, -1))
    return u[:, :N], u[:, N:]


# ---------------------------------------------------------------------------
# public surface
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GradResult:
    """Value and gradients of the realized allocation metrics.

    value : dict metric -> 0-d tensor (single cell) or (C,) (fleet) for
        each of `METRICS` = (objective, energy, time, accuracy).
    grads : dict metric -> {"weights": (3,) / (C, 3) gradient w.r.t. the
        RAW (w1, w2, rho) vector (the normalization included), plus one
        entry per `wrt` leaf, shaped like that leaf of the problem's
        system}.
    allocation : the realized `Allocation` (per-cell tensors on a fleet).
    wrt : the SystemParams leaf names differentiated.
    """
    value: Dict[str, Tensor]
    grads: Dict[str, Dict[str, Tensor]]
    allocation: Allocation
    wrt: Tuple[str, ...]


def _raw_weights(w, dtype, device, cells: Optional[int]) -> Tensor:
    """The raw (not normalized) (C, 3) weight operand: gradients are taken
    w.r.t. these entries, the w1 + w2 normalization inside the graph."""
    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    if isinstance(w, Weights):
        arr = torch.stack(torch.broadcast_tensors(t(w.w1), t(w.w2),
                                                  t(w.rho)), -1)
    elif isinstance(w, (list, tuple)) and w and isinstance(w[0], Weights):
        arr = t([[float(wc.w1), float(wc.w2), float(wc.rho)] for wc in w])
    else:
        arr = t(w)
    if arr.ndim == 0 or arr.shape[-1] != 3 or arr.ndim > 2:
        raise ValueError(
            f"solve_and_grad: weights must lower to (3,) or (C, 3), got "
            f"shape {tuple(arr.shape)}")
    if cells is None:
        if arr.ndim != 1:
            raise ValueError(
                "solve_and_grad: single-cell problem, but weights have a "
                f"cell axis ({tuple(arr.shape)})")
        return arr[None]
    if arr.ndim == 1:
        arr = arr.expand(cells, 3)
    if arr.shape[0] != cells:
        raise ValueError(
            f"solve_and_grad: {arr.shape[0]} weight rows for {cells} cells")
    return arr


def solve_and_grad(problem: Problem, spec: Optional[SolverSpec] = None, *,
                   wrt: Tuple[str, ...] = DEFAULT_WRT,
                   adjoint_iters: int = 30) -> GradResult:
    """Solve the allocation problem and differentiate the realized metrics.

    Returns the (objective, energy, time, accuracy) of the BCD fixed point
    with their gradients w.r.t. the raw weight vector and the requested
    `SystemParams` leaves, by implicit differentiation of the KKT
    conditions (module docstring). A stacked (C, N) system with (C, 3)
    weights differentiates every cell in one batched graph.

    problem : a plain BCD `Problem` (no mesh / rounds / deadline / assoc).
    spec : the forward solve's `SolverSpec`. For finite-difference-grade
        smoothness use sp1_method="bisect" with a tight tol in float64.
    wrt : SystemParams leaf names to differentiate (float leaves only).
    adjoint_iters : Neumann iterations of the adjoint fixed point; 0 takes
        the exact dense solve of the 2N-unknown adjoint system instead.
    """
    from ..api.solve import _apply_dtype

    spec = SolverSpec() if spec is None else spec
    if problem.mesh is not None or problem.rounds is not None \
            or problem.deadline is not None or problem.assoc is not None:
        raise ValueError(
            "solve_and_grad: only plain BCD problems are differentiable "
            "(mesh/rounds/deadline/assoc topologies are not)")
    for name in wrt:
        if name not in SYS_SCALARS + SYS_ARRAYS:
            raise ValueError(
                f"solve_and_grad: unknown SystemParams leaf {name!r}; "
                f"differentiable leaves are {SYS_SCALARS + SYS_ARRAYS}")
    wrt = tuple(wrt)
    sysp, init = _apply_dtype(problem.system, problem.init, spec.dtype)
    acc = problem.acc if problem.acc is not None else default_accuracy()
    cells = problem.cells
    batch = sysp.batched()
    alloc0 = init if init is not None else initial_allocation(batch)
    solver = _Solver(sys=batch, wrt=wrt, acc=acc, spec=spec,
                     state0=_init_carry_state(batch, alloc0),
                     adjoint_iters=int(adjoint_iters))
    lv = [getattr(batch, k).detach().clone().requires_grad_() for k in wrt]
    wr = _raw_weights(problem.weights, batch.dtype, batch.device,
                      cells).clone().requires_grad_()
    with torch.enable_grad():
        warr = wr / (wr[:, 0:1] + wr[:, 1:2])
        x = _FixedPoint.apply(solver, warr, *lv)
        mvec, alloc = _step_metrics(x, solver.build(lv), warr, acc)
        grads = {}
        for i, m in enumerate(METRICS):
            g = torch.autograd.grad(mvec[:, i].sum(), [wr, *lv],
                                    retain_graph=i + 1 < len(METRICS),
                                    allow_unused=True)
            g = [torch.zeros_like(t) if gi is None else gi
                 for t, gi in zip([wr, *lv], g)]
            grads[m] = {"weights": g[0] if cells is not None else g[0][0]}
            for name, gi in zip(wrt, g[1:]):
                grads[m][name] = gi.reshape(getattr(sysp, name).shape)
    mvec = mvec.detach()
    alloc = Allocation(**{f.name: getattr(alloc, f.name).detach()
                          for f in dataclasses.fields(alloc)})
    alloc.T = alloc.T[:, 0]
    if cells is None:
        mvec = mvec[0]
        alloc = Allocation(**{f.name: getattr(alloc, f.name)[0]
                              for f in dataclasses.fields(alloc)})
    value = {m: mvec[..., i] for i, m in enumerate(METRICS)}
    return GradResult(value=value, grads=grads, allocation=alloc, wrt=wrt)
