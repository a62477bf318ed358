"""Plain Algorithm 2 (paper arXiv:2211.08705, §V), the benchmark's reference.

A frozen copy of the allocator's arithmetic in plain PyTorch: every search
runs its fixed float64 depth, with no kernel, no carried bracket and no
Newton step, so its answer is the exact point the port's float32 searches
approximate. It imports nothing of the program. Every tensor carries the
cell axis: (C, N) per device, (C, 1) per cell. The dtype of the `System`
handed in is the dtype it computes in (float64 for the reference,
bfloat16 for the control).

Three solves, each on every cell at once:

  * `free`: the BCD of SP1 (a T-grid dual sweep on the closed-form
    lambda_n(T), then a secant step) and SP2 (boundary power, a bisection on
    the budget multiplier around a per-device bisection for B(mu)), each
    cell stopping on its own relative (B, p, f, s) step;
  * `deadline`: the deadline-constrained BCD of Figs. 8-9 (SP1 by
    enumeration of the resolution menu, the compute/transmit split by a
    golden section, SP2 as above);
  * `rounds`: R rounds of Markov-drifting shadowing with the free BCD
    warm-started round to round and "stale" participation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

Tensor = torch.Tensor

LN2 = math.log(2.0)
LOG10_E = math.log10(math.e)
GOLD = 0.6180339887498949

# the paper's linear accuracy through Fig. 7's YOLOv5m end points
# (160 px, 0.223 mAP) and (640 px, 0.402 mAP)
ACC_S_LO, ACC_A_LO = 160.0, 0.223
ACC_SLOPE = (0.402 - 0.223) / (640.0 - 160.0)

# search depths (the float64 ones of the allocator)
B_MIN_ITERS = 56
MU_ITERS = 56
B_ITERS = 48
SPLIT_ITERS = 48
SWEEP_POINTS, SWEEP_ROUNDS = 16, 3

SCALARS = ("bandwidth_total", "noise_psd", "p_min", "p_max", "f_min",
           "f_max", "kappa", "local_iters", "global_rounds", "s_standard")
ARRAYS = ("gain", "cycles", "samples", "bits")


@dataclasses.dataclass(frozen=True)
class System:
    """C cells of N devices: (C, N) arrays, (C, 1) per-cell scalars."""
    gain: Tensor
    cycles: Tensor
    samples: Tensor
    bits: Tensor
    bandwidth_total: Tensor
    noise_psd: Tensor
    p_min: Tensor
    p_max: Tensor
    f_min: Tensor
    f_max: Tensor
    kappa: Tensor
    local_iters: Tensor
    global_rounds: Tensor
    s_standard: Tensor
    resolutions: tuple

    def to(self, dtype=None, device=None) -> "System":
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device=device, dtype=dtype)
            for k in ARRAYS + SCALARS})

    def rows(self, idx: Tensor) -> "System":
        return dataclasses.replace(self, **{
            k: getattr(self, k)[idx] for k in ARRAYS + SCALARS})

    def replace(self, **kw) -> "System":
        return dataclasses.replace(self, **kw)

    @property
    def zeta(self) -> Tensor:
        return 1.0 / (self.s_standard * self.s_standard)


def tiny(x: Tensor) -> float:
    return torch.finfo(x.dtype).tiny


def clip(x: Tensor, lo, hi) -> Tensor:
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def log2(x: Tensor) -> Tensor:
    return torch.log(x) * (1.0 / LN2)


def exp2(x: Tensor) -> Tensor:
    return torch.exp(x * LN2)


def cbrt(x: Tensor) -> Tensor:
    return x.pow(1.0 / 3.0)


def accuracy(s: Tensor) -> Tensor:
    return ACC_SLOPE * (s - ACC_S_LO) + ACC_A_LO


# ---------------------------------------------------------------------------
# the system model (eqs. 1-13)
# ---------------------------------------------------------------------------

def rate(sys: System, B: Tensor, p: Tensor) -> Tensor:
    b = torch.clamp_min(B, 1e-9)
    return b * log2(1.0 + sys.gain * p / (sys.noise_psd * b))


def t_trans(sys: System, B: Tensor, p: Tensor) -> Tensor:
    return sys.bits / torch.clamp_min(rate(sys, B, p), 1e-12)


def cycles_per_round(sys: System, s: Tensor) -> Tensor:
    return sys.local_iters * sys.zeta * (s * s) * sys.cycles * sys.samples


def t_cmp(sys: System, f: Tensor, s: Tensor) -> Tensor:
    return cycles_per_round(sys, s) / torch.clamp_min(f, 1e-9)


def energy_parts(sys: System, B, p, f, s):
    """Per device and round: (transmit energy, compute energy, time)."""
    tt = t_trans(sys, B, p)
    return p * tt, sys.kappa * cycles_per_round(sys, s) * (f * f), \
        t_cmp(sys, f, s) + tt


def totals(sys: System, B, p, f, s) -> Tuple[Tensor, Tensor, Tensor]:
    """(E, T, A) of each cell, (C, 1): eqs. (9), (11) and sum A_n."""
    e_tr, e_cp, t = energy_parts(sys, B, p, f, s)
    E = sys.global_rounds * (e_tr + e_cp).sum(-1, keepdim=True)
    T = sys.global_rounds * t.amax(-1, keepdim=True)
    return E, T, accuracy(s).sum(-1, keepdim=True)


def objective(sys: System, w, B, p, f, s) -> Tensor:
    """w1 E + w2 T - rho A (eq. 12), (C, 1)."""
    E, T, A = totals(sys, B, p, f, s)
    return w[0] * E + w[1] * T - w[2] * A


def objective_scale(sys: System, w, B, p, f, s) -> Tensor:
    """w1 E + w2 T + rho A: the size of the objective's terms, (C, 1)."""
    E, T, A = totals(sys, B, p, f, s)
    return w[0] * E + w[1] * T + w[2] * A


def weights(w, C: int, like: Tensor):
    """(w1, w2, rho) normalised by w1 + w2, each (C, 1)."""
    s = w[0] + w[1]
    return tuple(torch.full((C, 1), x / s, dtype=like.dtype,
                            device=like.device) for x in w)


# ---------------------------------------------------------------------------
# SP1: (f, s, T) given (B, p), the T-grid dual sweep
# ---------------------------------------------------------------------------

def lambda_of_T(T, q, tt, k3, rhok, f_min, f_max, s_lo, s_hi, lam_hi):
    """Exact lambda_n(T) of the linear accuracy: the smallest of the
    error-minimising candidates among lambda = 0, f at either end of its
    box, s at either end of its box, and both interior."""
    eps = tiny(q)
    t_c = torch.clamp_min(T - tt, eps)
    q_safe = torch.clamp_min(q, eps)
    alpha = 0.5 * k3 * q
    k3_safe = torch.clamp_min(k3, eps)

    def makespan_err(lam):
        f = clip(cbrt(lam / k3_safe), f_min, f_max)
        fs = torch.clamp_min(f, 1e-9)
        psi = 2.0 * alpha * (f * f) + 2.0 * lam * q / fs
        s = clip(rhok / torch.clamp_min(psi, eps), s_lo, s_hi)
        return torch.abs(q * (s * s) / fs - t_c)

    def f_pinned(F):
        s = torch.sqrt(t_c * F / q_safe)
        return (rhok / torch.clamp_min(s, eps) - 2.0 * alpha * (F * F)) \
            * F / (2.0 * q_safe)

    def s_pinned(S):
        f = q * (S * S) / t_c
        return k3 * (f * f * f)

    f6 = (rhok / torch.clamp_min(3.0 * k3, eps)) ** 0.4 \
        * torch.clamp_min(q * t_c, eps) ** -0.2
    cands = torch.stack(torch.broadcast_tensors(
        torch.zeros_like(t_c), f_pinned(f_min), f_pinned(f_max),
        s_pinned(s_lo), s_pinned(s_hi), k3 * (f6 * f6 * f6)))
    lam_hi = torch.as_tensor(lam_hi, dtype=q.dtype, device=q.device)
    cands = torch.where(torch.isnan(cands), lam_hi, clip(cands, 0.0, lam_hi))
    err = makespan_err(cands)
    near = err <= err.amin(0) * (1.0 + 1e-6) + eps
    inf = torch.full((), float("inf"), dtype=q.dtype, device=q.device)
    lam = torch.where(near, cands, inf).amin(0)
    floor = q * (s_lo * s_lo) / torch.clamp_min(
        torch.as_tensor(f_max, dtype=q.dtype, device=q.device), 1e-9)
    return torch.where(floor > t_c, lam_hi, lam)


def geomspace(lo: Tensor, hi: Tensor, n: int) -> Tensor:
    a, b = torch.log(lo) * LOG10_E, torch.log(hi) * LOG10_E
    step = torch.arange(n - 1, dtype=lo.dtype, device=lo.device) / (n - 1)
    return torch.pow(10.0, torch.cat([a * (1 - step) + b * step, b], -1))


def bracket(S: Tensor, target: Tensor, grid: Tensor):
    n = S.shape[-1]
    index = torch.arange(n, device=S.device)
    first = torch.where(S < target, index, n).amin(-1, keepdim=True)
    idx = torch.where(first == n, n - 1, torch.clamp_min(first, 1))
    return (grid.gather(-1, idx - 1), grid.gather(-1, idx),
            S.gather(-1, idx - 1), S.gather(-1, idx))


def round_resolution(sys: System, s_hat: Tensor) -> Tensor:
    res = torch.as_tensor(sys.resolutions, dtype=s_hat.dtype,
                          device=s_hat.device)
    return res[(s_hat[..., None] - res).abs().argmin(-1)]


def sp1(sys: System, w, tt: Tensor):
    """(f, s, s_hat, T) for transmit times tt; T (C, 1)."""
    w1, w2, rho = w
    w2 = torch.clamp_min(w2, 1e-9)
    q = sys.local_iters * sys.zeta * sys.cycles * sys.samples
    s_lo, s_hi = sys.resolutions[0], sys.resolutions[-1]
    k3 = 2.0 * w1 * sys.global_rounds * sys.kappa
    rhok = rho * ACC_SLOPE
    lam_hi = torch.clamp_min(torch.maximum(
        k3 * (sys.f_max * sys.f_max * sys.f_max), w2 * sys.global_rounds),
        1.0) * 1e4
    target = w2 * sys.global_rounds
    lo = (q * s_lo ** 2 / sys.f_max + tt).amax(-1, keepdim=True) \
        * (1.0 + 1e-12)
    hi = (q * s_hi ** 2 / torch.clamp_min(sys.f_min, 1e-3)
          + tt).amax(-1, keepdim=True) * 2.0

    def lam_of(T):
        return lambda_of_T(T, q, tt, k3, rhok, sys.f_min, sys.f_max, s_lo,
                           s_hi, lam_hi)

    for _ in range(SWEEP_ROUNDS):
        grid = geomspace(lo, hi, SWEEP_POINTS)
        S = torch.stack([lam_of(grid[:, m:m + 1]).sum(-1)
                         for m in range(SWEEP_POINTS)], -1)
        lo, hi, S_lo, S_hi = bracket(S, target, grid)
    t = clip((S_lo - target) / torch.clamp_min(S_lo - S_hi, tiny(lo)),
             0.0, 1.0)
    T = lo + t * (hi - lo)
    lam = lam_of(T)
    f = clip(cbrt(lam / torch.clamp_min(k3, tiny(lam))), sys.f_min,
             sys.f_max)
    alpha = w1 * sys.global_rounds * sys.kappa * q
    psi = 2.0 * alpha * (f * f) + 2.0 * lam * q / torch.clamp_min(f, 1e-9)
    s_hat = clip(rhok / torch.clamp_min(psi, tiny(psi)), s_lo, s_hi)
    s = round_resolution(sys, s_hat)
    T_out = (q * (s * s) / torch.clamp_min(f, 1e-9) + tt).amax(
        -1, keepdim=True)
    return f, s, s_hat, torch.maximum(T, T_out)


def sp1_fixed(sys: System, w, tt: Tensor, T_round: Tensor):
    """Deadline SP1: per device and menu option the least feasible f, then
    the option of least w1 Rg kappa q s^2 f^2 - rho A(s). (f, s)."""
    w1, _, rho = w
    q = sys.local_iters * sys.zeta * sys.cycles * sys.samples
    alpha = w1 * sys.global_rounds * sys.kappa * q
    res = torch.as_tensor(sys.resolutions, dtype=tt.dtype, device=tt.device)
    budget = torch.clamp_min(T_round - tt, 1e-9)[..., None]
    f_req = q[..., None] * (res * res) / budget
    feas = f_req <= sys.f_max[..., None] * (1.0 + 1e-9)
    f_opt = torch.minimum(torch.maximum(f_req, sys.f_min[..., None]),
                          sys.f_max[..., None])
    obj = alpha[..., None] * (res * res) * (f_opt * f_opt) \
        - rho[..., None] * accuracy(res)
    obj = torch.where(feas, obj, torch.full((), float("inf"),
                                            dtype=obj.dtype,
                                            device=obj.device))
    pick = obj.argmin(-1, keepdim=True)
    return f_opt.gather(-1, pick)[..., 0], res[pick[..., 0]]


# ---------------------------------------------------------------------------
# SP2: (p, B) given the rate floors, exactly
# ---------------------------------------------------------------------------

def G(sys: System, p: Tensor, B: Tensor) -> Tensor:
    b = torch.clamp_min(B, 1e-12)
    return b * log2(1.0 + sys.gain * p / (sys.noise_psd * b))


def r_min(sys: System, f: Tensor, s: Tensor, T: Tensor) -> Tensor:
    slack = torch.clamp_min(T - t_cmp(sys, f, s), 1e-9)
    return sys.bits / slack


def denergy_dB(sys: System, rmin: Tensor, B: Tensor) -> Tensor:
    """dE_n/dB of E_n(B) = p(B) d / G(p(B), B), p = clip(p_rate, box)."""
    N0, g, d = sys.noise_psd, sys.gain, sys.bits
    Bs = torch.clamp_min(B, 1e-12)
    x = rmin / Bs
    ex = exp2(x)
    p_rate = (ex - 1.0) * N0 * Bs / g
    dE_rate = (N0 * d / (g * torch.clamp_min(rmin, 1e-30))) \
        * (ex * (1.0 - x * LN2) - 1.0)
    pc = torch.where(p_rate < sys.p_min, sys.p_min, sys.p_max)
    t = g * pc / (N0 * Bs)
    L = torch.log1p(t)
    Gc = torch.clamp_min(Bs * L / LN2, 1e-12)
    Gp = (L - t / (1.0 + t)) / LN2
    dE_clip = -pc * d * Gp / (Gc * Gc)
    on_rate = (p_rate >= sys.p_min) & (p_rate <= sys.p_max)
    return torch.where(on_rate, dE_rate, dE_clip)


def sp2(sys: System, rmin: Tensor) -> Tuple[Tensor, Tensor]:
    """(p, B): the least transmit energy with G(p_n, B_n) >= rmin_n and
    sum B_n <= B_total, by a bisection on the budget's multiplier mu
    around a full-depth bisection of each device's B(mu)."""
    Btot = sys.bandwidth_total
    rmin = torch.minimum(rmin, 0.95 * sys.gain * sys.p_max
                         / (sys.noise_psd * LN2))
    # rate floors: the least B with G(p_max, B) >= rmin
    lo = torch.full_like(rmin, 1e-3)
    hi = torch.broadcast_to(Btot, rmin.shape)
    p_max = torch.broadcast_to(sys.p_max, rmin.shape)
    for _ in range(B_MIN_ITERS):
        mid = 0.5 * (lo + hi)
        ok = G(sys, p_max, mid) >= rmin
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    b_lo = hi
    fit = torch.clamp_max(0.999 * Btot / torch.clamp_min(
        b_lo.sum(-1, keepdim=True), 1e-30), 1.0)
    b_lo = b_lo * fit
    b_hi = torch.maximum(torch.broadcast_to(Btot, b_lo.shape), b_lo)

    def B_of(mu):
        lo, hi = b_lo, b_hi
        for _ in range(B_ITERS):
            mid = 0.5 * (lo + hi)
            pos = denergy_dB(sys, rmin, mid) + mu >= 0.0
            lo, hi = torch.where(pos, lo, mid), torch.where(pos, mid, hi)
        return 0.5 * (lo + hi)

    mu_hi = torch.clamp_min((-denergy_dB(sys, rmin, b_lo)).amax(
        -1, keepdim=True), 1e-30) * (1.0 + 1e-3)
    mu_lo = torch.zeros_like(mu_hi)
    for _ in range(MU_ITERS):
        mid = 0.5 * (mu_lo + mu_hi)
        over = B_of(mid).sum(-1, keepdim=True) > Btot
        mu_lo = torch.where(over, mid, mu_lo)
        mu_hi = torch.where(over, mu_hi, mid)
    B = B_of(mu_hi)
    total = B.sum(-1, keepdim=True)
    surplus = torch.clamp_min(B - b_lo, 0.0)
    scale = 1.0 - (total - Btot) / torch.clamp_min(
        surplus.sum(-1, keepdim=True), 1e-30)
    B = torch.where(total > Btot, b_lo + surplus * clip(scale, 0.0, 1.0), B)
    p_rate = (exp2(rmin / torch.clamp_min(B, 1e-9)) - 1.0) \
        * sys.noise_psd * B / sys.gain
    return torch.minimum(torch.maximum(p_rate, sys.p_min), sys.p_max), B


# ---------------------------------------------------------------------------
# the BCD loops
# ---------------------------------------------------------------------------

def initial(sys: System, bandwidth_frac: float = 1.0):
    """(B, p, f, s, s_hat, T): B_total / N each, p_max, f_max, s_lo."""
    C, N = sys.gain.shape
    full = torch.ones_like(sys.gain)
    s0 = full * sys.resolutions[0]
    return (full * (sys.bandwidth_total / N * bandwidth_frac),
            full * sys.p_max, full * sys.f_max, s0, s0.clone(),
            torch.zeros_like(sys.bandwidth_total))


def bcd(state, step, max_iters: int, tol: float):
    """Each cell runs `step` until its relative (B, p, f, s) step is at
    most `tol` or it has run `max_iters` times; a finished cell's state
    stays as it was. Returns (state, metrics of each cell's last step,
    iterations (C,))."""
    C = state[0].shape[0]
    device = state[0].device
    iters = torch.zeros(C, dtype=torch.int64, device=device)
    running = torch.ones(C, dtype=torch.bool, device=device)
    prev = torch.cat(state[:4], -1)
    metrics = None
    for _ in range(max_iters):
        new, m = step(state)
        cur = torch.cat(new[:4], -1)
        rel = torch.linalg.vector_norm(cur - prev, dim=-1) / torch.clamp_min(
            torch.linalg.vector_norm(prev, dim=-1), 1e-12)
        keep = running[:, None]
        state = tuple(torch.where(keep, a, b) for a, b in zip(new, state))
        metrics = m if metrics is None else tuple(
            torch.where(keep, a, b) for a, b in zip(m, metrics))
        prev = torch.where(keep, cur, prev)
        iters = iters + running.long()
        running = running & ~(rel <= tol)
        if not bool(running.any()):
            break
    return state, metrics, iters


def free(sys: System, w, max_iters: int, tol: float, state=None):
    """Algorithm 2. Returns dict of B, p, f, s, s_hat, T (C, 1), iters,
    objective (C, 1)."""
    w = weights(w, sys.gain.shape[0], sys.gain)

    def step(state):
        B, p = state[0], state[1]
        tt = sys.bits / torch.clamp_min(rate(sys, B, p), 1e-12)
        f, s, s_hat, T = sp1(sys, w, tt)
        p2, B2 = sp2(sys, r_min(sys, f, s, T))
        return (B2, p2, f, s, s_hat, T), (objective(sys, w, B2, p2, f, s),)

    state = initial(sys) if state is None else state
    state, (obj,), iters = bcd(state, step, max_iters, tol)
    return dict(zip(("B", "p", "f", "s", "s_hat", "T"), state),
                iters=iters, objective=obj)


def optimal_split(sys: System, s: Tensor, B: Tensor, T_round: Tensor):
    """Each device's transmit time in the round deadline that least costs
    compute plus transmit energy, by a golden section."""
    cyc = cycles_per_round(sys, s)

    def energy(tt):
        f = clip(cyc / torch.clamp_min(T_round - tt, 1e-9), sys.f_min,
                 sys.f_max)
        r_req = sys.bits / torch.clamp_min(tt, 1e-9)
        theta = exp2(r_req / torch.clamp_min(B, 1e-9)) - 1.0
        p = clip(theta * sys.noise_psd * B / sys.gain, sys.p_min, sys.p_max)
        return sys.kappa * cyc * (f * f) + p * tt

    tt_min = sys.bits / torch.clamp_min(B * log2(
        1.0 + sys.gain * sys.p_max
        / (sys.noise_psd * torch.clamp_min(B, 1e-9))), 1e-12)
    a = torch.minimum(tt_min, 0.95 * T_round)
    b = torch.broadcast_to(0.95 * T_round, a.shape)
    c, d = b - GOLD * (b - a), a + GOLD * (b - a)
    fc, fd = energy(c), energy(d)
    for _ in range(SPLIT_ITERS):
        left = fc < fd
        a2, b2 = torch.where(left, a, c), torch.where(left, d, b)
        c2 = torch.where(left, b2 - GOLD * (b2 - a2), d)
        d2 = torch.where(left, c, a2 + GOLD * (b2 - a2))
        f_new = energy(torch.where(left, c2, d2))
        fc, fd = torch.where(left, f_new, fd), torch.where(left, fc, f_new)
        a, b, c, d = a2, b2, c2, d2
    return clip(0.5 * (a + b), tt_min, 0.95 * T_round)


def deadline(sys: System, w, deadline_total: Tensor, max_iters: int,
             tol: float):
    """Energy under each cell's total deadline (C, 1). Returns dict as
    `free`, objective = the energy E."""
    w = weights(w, sys.gain.shape[0], sys.gain)
    T_round = deadline_total / sys.global_rounds

    def step(state):
        B, p = state[0], state[1]
        tt = sys.bits / torch.clamp_min(rate(sys, B, p), 1e-12)
        f, s = sp1_fixed(sys, w, tt, T_round)
        p2, B2 = sp2(sys, sys.bits / optimal_split(sys, s, B, T_round))
        tt2 = sys.bits / torch.clamp_min(rate(sys, B2, p2), 1e-12)
        f = clip(cycles_per_round(sys, s)
                 / torch.clamp_min(T_round - tt2, 1e-9), sys.f_min,
                 sys.f_max)
        E, _, _ = totals(sys, B2, p2, f, s)
        return (B2, p2, f, s, state[4], T_round), (E,)

    state, (E,), iters = bcd(initial(sys), step, max_iters, tol)
    return dict(zip(("B", "p", "f", "s", "s_hat", "T"), state),
                iters=iters, objective=E)


def rounds(sys: System, w, shadow0: Tensor, z: Tensor, drop: Tensor,
           n_rounds: int, bcd_iters: int, tol: float, drift_rho: float,
           shadowing_db: float, max_staleness: int, decay: float,
           deadline_slack: float):
    """R rounds of Markov shadowing drift, the free BCD warm-started round
    to round, and stale participation. z, drop (C, R, N). Returns dict of
    the final state, and per round (C, R): objective, energy, time,
    arrived utility, late and dropped counts; resolutions (C, R, N)."""
    C, N = sys.gain.shape
    sigma = shadowing_db * math.log(10.0) / 10.0
    shadow_mean = math.exp(sigma * sigma / 2.0)
    wn = weights(w, C, sys.gain)
    K = max_staleness
    qw = qu = torch.zeros((C, K), dtype=sys.gain.dtype,
                          device=sys.gain.device)
    state = initial(sys)
    shadow = shadow0
    out = {k: [] for k in ("objective", "scale", "energy", "time", "arrived_u",
                           "arrived_w", "late", "dropped", "s", "iters")}
    w_total = sys.samples.sum(-1)
    for r in range(n_rounds):
        shadow = drift_rho * shadow + math.sqrt(
            max(1.0 - drift_rho * drift_rho, 0.0)) * z[:, r]
        g = sys.gain / shadow_mean * torch.exp(sigma * shadow)
        sys_r = sys.replace(gain=g)
        res = free(sys_r, w, bcd_iters, tol, state=state)
        state = tuple(res[k] for k in ("B", "p", "f", "s", "s_hat", "T"))
        B, p, f, s, _, T = state
        e_tr, e_cp, t_dev = energy_parts(sys_r, B, p, f, s)
        util = accuracy(s)
        active = ~drop[:, r]
        dl = torch.clamp_min(deadline_slack * T, tiny(T))
        kst = torch.clamp(torch.ceil(t_dev / dl) - 1.0, 0, K).long()
        late = active & (kst > 0)
        ontime = active & ~late
        zero = torch.zeros((), dtype=g.dtype, device=g.device)

        def msum(x, m):
            return torch.where(m, x, zero).sum(-1)

        closes = torch.where(late.any(-1), (deadline_slack * T)[:, 0],
                             torch.where(ontime, t_dev, zero).amax(-1))
        disc = decay ** kst.to(g.dtype)
        push = torch.clamp_min(kst - 1, 0)
        pop_w, pop_u = qw[:, 0], qu[:, 0]
        pad = torch.zeros_like(qw[:, :1])
        qw = torch.cat([qw[:, 1:], pad], -1).scatter_add(
            -1, push, torch.where(late, sys.samples * disc, zero))
        qu = torch.cat([qu[:, 1:], pad], -1).scatter_add(
            -1, push, torch.where(late, util * disc, zero))
        out["objective"].append(objective(sys_r, wn, B, p, f, s)[:, 0])
        out["scale"].append(objective_scale(sys_r, wn, B, p, f, s)[:, 0])
        out["energy"].append(msum(e_tr + e_cp, active))
        out["time"].append(closes)
        out["arrived_u"].append(msum(util, ontime) + pop_u)
        out["arrived_w"].append((msum(sys.samples, ontime) + pop_w)
                                / w_total)
        out["late"].append(late.sum(-1))
        out["dropped"].append((~active).sum(-1))
        out["s"].append(s)
        out["iters"].append(res["iters"])
    result = {k: torch.stack(v, 1) for k, v in out.items()}
    result.update(zip(("B", "p", "f", "s_final", "s_hat", "T"), state))
    return result
