"""Algorithm 2: the BCD resource-allocation loop (paper §V-D).

Port of `repro/core/bcd.py`. One loop, `_bcd_while`, solves a whole
stack of cells at once: per-cell convergence on the relative (B, p, f, s)
step (floored at 64 ulps of the carry dtype), a NaN-padded iteration
ledger, and a finished cell's carry frozen while the others go on — what
`jax.vmap` of the reference's `lax.while_loop` does. A single cell is a
stack of one. Two step functions run in it: the free-deadline Algorithm 2
(`_allocate_impl`, SP1 "sweep" or "bisect", SP2 "direct" or "jong") and
the deadline-constrained variant of the paper's Figs. 8-9
(`_allocate_fixed_impl`, one deadline per cell).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import energy as en
from .accuracy import AccuracyModel
from .energy import rate as _rate
from .loops import while_cells
from .sp1 import _SP1_IMPLS, _solve_sp1_fixed_impl, dual_evals_per_iter
from .sp2 import (_exp2, _golden_argmin, _sp2_direct_impl, _sp2_jong_core,
                  r_min)
from .types import SYS_ARRAYS, SYS_SCALARS, Allocation, SystemParams, Weights

Tensor = torch.Tensor

# ledger column order (one row per BCD iteration). sp2_iters: Jong outer
# iterations for sp2_method="jong"; for "direct" the measured dE/dB
# evaluation count of the carried-bracket dual search.
_LEDGER_COLS = ("objective", "energy", "time", "accuracy",
                "sp2_iters", "sp2_residual", "rel_step")
_FIXED_COLS = ("energy", "time", "accuracy", "sp2_evals", "rel_step")

# solver-effort counter order (SolveCounters.data last axis)
_COUNTER_COLS = ("bcd_iters", "sp1_evals", "sp2_evals", "residual")


@dataclasses.dataclass
class SolveCounters:
    """Solver-effort counters for one solve, still on the device: `data` is
    (len(columns),) for a single cell, (C, len(columns)) for a fleet."""
    data: Tensor
    columns: tuple = _COUNTER_COLS

    def col(self, name: str) -> Tensor:
        """One counter by name; leading cell axis kept."""
        return self.data[..., self.columns.index(name)]

    @property
    def bcd_iters(self) -> Tensor:
        return self.col("bcd_iters")

    @property
    def sp1_evals(self) -> Tensor:
        return self.col("sp1_evals")

    @property
    def sp2_evals(self) -> Tensor:
        return self.col("sp2_evals")

    @property
    def residual(self) -> Tensor:
        return self.col("residual")

    def as_dict(self) -> dict:
        """{name: float | (C,) ndarray} — one device->host copy."""
        vals = self.data.cpu().numpy()
        out = {}
        for i, c in enumerate(self.columns):
            v = vals[..., i]
            out[c] = float(v) if v.ndim == 0 else v
        return out


@dataclasses.dataclass
class BCDResult:
    allocation: Allocation
    objective: float
    history: List[dict]
    iters: int
    converged: bool
    counters: Optional[SolveCounters] = None


@dataclasses.dataclass
class FleetResult:
    """Batched BCD solve across C cells: allocation tensors are (C, N),
    per-cell values (C,). `history` is the raw iteration ledger
    (C, max_iters, len(columns)); rows past a cell's `iters` are NaN."""
    allocation: Allocation
    objective: Tensor        # (C,)
    iters: Tensor            # (C,) int32
    converged: Tensor        # (C,) bool
    history: Tensor          # (C, max_iters, len(columns))
    columns: tuple = _LEDGER_COLS
    counters: Optional[SolveCounters] = None   # (C, 4)


def initial_allocation(sys: SystemParams,
                       bandwidth_frac: float = 1.0) -> Allocation:
    """Feasible start: p = pmax, B = B/N (paper init; Fig. 9 uses B/(2N),
    `bandwidth_frac` = 0.5). On a padded system the split divides by the
    active device count and pad lanes start at B = 0. Tensors are shaped
    like the system's: (N,) or (C, N)."""
    b = sys.batched()
    shape = b.gain.shape
    if b.active is None:
        bw = torch.broadcast_to(b.bandwidth_total / sys.n * bandwidth_frac,
                                shape)
    else:
        n_eff = b.active.to(b.dtype).sum(-1, keepdim=True)
        share = b.bandwidth_total / n_eff * bandwidth_frac
        bw = torch.where(b.active, share,
                         torch.zeros((), dtype=b.dtype, device=b.device))

    def full(v):
        return torch.broadcast_to(v, shape).reshape(sys.gain.shape).clone()

    return Allocation(bandwidth=full(bw), power=full(b.p_max),
                      freq=full(b.f_max),
                      resolution=full(torch.full_like(b.p_max, sys.s_lo)))


def _init_carry_state(sys: SystemParams, alloc: Allocation):
    """(B, p, f, s, s_hat, T) for the loop carry: (C, N) tensors and a
    (C, 1) T, on a batched system."""
    C, N = sys.gain.shape
    s_hat = alloc.s_relaxed if alloc.s_relaxed is not None \
        else alloc.resolution
    T = alloc.T if alloc.T is not None \
        else torch.zeros((), dtype=sys.dtype, device=sys.device)
    fields = (alloc.bandwidth, alloc.power, alloc.freq, alloc.resolution,
              s_hat)
    return (*(x.reshape(C, N) for x in fields),
            torch.broadcast_to(T.reshape(-1, 1), (C, 1)).contiguous())


def _bcd_while(state0, max_iters: int, ncols: int, tol, step, mask=None):
    """Shared BCD loop over a (C, N) stack: fixed-size NaN ledger,
    per-cell convergence on the relative (B, p, f, s) step. `step(state)`
    performs one block-coordinate update of every cell and returns
    (new_state, metrics), each metric (C,); the loop appends the
    rel-step column and writes the ledger row.

    The tolerance is floored at 64 ulps of the carry dtype: below that the
    iterate movement is solver bracketing noise, not progress. `mask`
    ((C, N) bool, `sys.active`) zeroes padded-out devices in the rel-step
    norms. Returns (*state, iters (C,), converged (C,), ledger)."""
    B0 = state0[0]
    C, dtype, device = B0.shape[0], B0.dtype, B0.device
    ledger0 = torch.full((C, max_iters, ncols), float("nan"), dtype=dtype,
                         device=device)
    k0 = torch.zeros(C, dtype=torch.int32, device=device)
    conv0 = torch.zeros(C, dtype=torch.bool, device=device)
    if max_iters == 0:   # nothing to iterate: return the start point untouched
        return (*state0, k0, conv0, ledger0)
    tol = max(float(tol), 64.0 * torch.finfo(dtype).eps)
    m4 = None if mask is None else torch.cat([mask] * 4, -1)
    cells = torch.arange(C, device=device)

    def flat(state):
        v = torch.cat(state[:4], -1)
        return v if m4 is None else torch.where(
            m4, v, torch.zeros((), dtype=dtype, device=device))

    def norm(v):
        return torch.sqrt((v * v).sum(-1))

    def cond(c):
        k, conv = c[0], c[1]
        return (k < max_iters) & ~conv

    def body(c):
        k, _, prev, ledger, *state = c
        state, metrics = step(tuple(state))
        cur = flat(state)
        rel = norm(cur - prev) / torch.clamp_min(norm(prev), 1e-12)
        row = torch.stack([*(m.to(dtype) for m in metrics), rel.to(dtype)],
                          -1)
        ledger = ledger.index_put((cells, k.long()), row)
        return (k + 1, rel <= tol, cur, ledger, *state)

    k, conv, _, ledger, *state = while_cells(
        cond, body, (k0, conv0, flat(state0), ledger0, *state0))
    return (*state, k, conv, ledger)


def _pack_counters(iters: Tensor, ledger: Tensor, max_iters: int,
                   sp2_col: int, rel_col: int, sp1_per_iter: int) -> Tensor:
    """(C, len(_COUNTER_COLS)) solver-effort counters reduced from the
    ledger: NaN rows (beyond `iters`) drop out of the sums; residual is the
    rel-step of the last executed iteration (NaN when nothing ran)."""
    dtype = ledger.dtype
    it = iters.to(dtype)
    sp1 = it * sp1_per_iter
    if max_iters > 0:
        sp2 = torch.nansum(ledger[:, :, sp2_col], -1)
        last = torch.clamp(iters.long() - 1, 0, max_iters - 1)
        residual = torch.where(
            iters > 0,
            ledger[:, :, rel_col].gather(-1, last[:, None])[:, 0],
            torch.full((), float("nan"), dtype=dtype, device=ledger.device))
    else:
        sp2 = torch.zeros_like(it)
        residual = torch.full_like(it, float("nan"))
    return torch.stack([it, sp1, sp2, residual], -1)


def _allocate_impl(sys: SystemParams, warr: Tensor, acc: AccuracyModel,
                   state0, max_iters: int, tol, sp1_method: str = "sweep",
                   sp2_method: str = "direct", sp2_iters: int = 30):
    """Algorithm 2 on a batched system, warr (C, 3). Returns (B, p, f, s,
    s_hat, T, iters, converged, ledger, counters)."""
    dtype = state0[0].dtype
    warr_sp1 = torch.stack([warr[:, 0], torch.clamp_min(warr[:, 1], 1e-9),
                            warr[:, 2]], -1)
    w = Weights(warr[:, 0:1], warr[:, 1:2], warr[:, 2:3])
    solve_sp1 = _SP1_IMPLS[sp1_method]

    def step(state):
        B, p = state[0], state[1]
        tt = sys.bits / torch.clamp_min(_rate(sys, B, p), 1e-12)
        f, s, s_hat, T = solve_sp1(sys, warr_sp1, acc, tt)
        rmin = r_min(sys, f, s, T)
        if sp2_method == "direct":
            p_new, B_new, ev = _sp2_direct_impl(sys, rmin)
            sp2_it = ev.to(dtype)
            sp2_res = torch.zeros_like(sp2_it)
        else:
            p_new, B_new, _, _, it2, res2 = _sp2_jong_core(
                sys, w.w1, rmin, p, B, max_iters=sp2_iters)
            sp2_it, sp2_res = it2.to(dtype), res2.to(dtype)
        alloc = Allocation(bandwidth=B_new, power=p_new, freq=f, resolution=s,
                           s_relaxed=s_hat, T=T)
        metrics = tuple(m[:, 0] for m in (
            en.objective(sys, w, acc, alloc), en.total_energy(sys, alloc),
            en.total_time(sys, alloc),
            en.total_accuracy(acc, alloc, sys.active)))
        return (B_new, p_new, f, s, s_hat, T), metrics + (sp2_it, sp2_res)

    out = _bcd_while(state0, max_iters, len(_LEDGER_COLS), tol, step,
                     mask=sys.active)
    counters = _pack_counters(out[6], out[8], max_iters,
                              _LEDGER_COLS.index("sp2_iters"),
                              _LEDGER_COLS.index("rel_step"),
                              dual_evals_per_iter(sp1_method, acc))
    return (*out, counters)


def _optimal_split(sys: SystemParams, s: Tensor, bandwidth: Tensor,
                   T_round: Tensor, iters: int = 48) -> Tensor:
    """Per-device golden section over the transmission-time share tt of the
    round deadline: E(tt) = kappa cyc^3 / (T - tt)^2 + E_trans_min(tt | B),
    both terms convex. Returns tt* clipped to the feasible window."""
    cyc = en.cycles_per_round(sys, s)

    def energy(tt):
        f = torch.minimum(torch.maximum(
            cyc / torch.clamp_min(T_round - tt, 1e-9), sys.f_min), sys.f_max)
        e_cmp = sys.kappa * cyc * (f * f)
        r_req = sys.bits / torch.clamp_min(tt, 1e-9)
        theta = _exp2(r_req / torch.clamp_min(bandwidth, 1e-9)) - 1.0
        p = torch.minimum(torch.maximum(
            theta * sys.noise_psd * bandwidth / sys.gain, sys.p_min),
            sys.p_max)
        return e_cmp + p * tt

    tt_min = sys.bits / torch.clamp_min(bandwidth * en.log2(
        1.0 + sys.gain * sys.p_max
        / (sys.noise_psd * torch.clamp_min(bandwidth, 1e-9))), 1e-12)
    a0 = torch.minimum(tt_min, 0.95 * T_round)
    b0 = torch.broadcast_to(0.95 * T_round, a0.shape)
    tt = _golden_argmin(energy, a0, b0, iters=iters)
    return torch.minimum(torch.maximum(tt, tt_min), 0.95 * T_round)


def _allocate_fixed_impl(sys: SystemParams, warr: Tensor, acc: AccuracyModel,
                         T_round: Tensor, state0, max_iters: int, tol,
                         sp2_method: str = "direct", sp2_iters: int = 30):
    """Deadline-constrained BCD (Figs. 8-9 variant) on a batched system:
    warr (C, 3), T_round (C, 1) the per-round deadline of each cell. SP1 is
    the closed-form enumeration of `_solve_sp1_fixed_impl` (no T search, so
    no SP1 dual evaluations); SP2 is "direct" or "jong". Returns the same
    tuple as `_allocate_impl`, with the `_FIXED_COLS` ledger."""
    dtype = state0[0].dtype

    def step(state):
        B, p, s_hat = state[0], state[1], state[4]
        tt = sys.bits / torch.clamp_min(_rate(sys, B, p), 1e-12)
        f, s = _solve_sp1_fixed_impl(sys, warr, acc, tt, T_round)
        # with a hard deadline SP1 pins t_cmp = T - t_trans(p, B), so SP2's
        # rate floor would equal the current rate and (p, B) could never
        # move: derive the floor from each device's optimal compute /
        # transmit split instead
        rmin = sys.bits / _optimal_split(sys, s, B, T_round)
        if sp2_method == "direct":
            p_new, B_new, ev = _sp2_direct_impl(sys, rmin)
        else:
            p_new, B_new, _, _, ev, _ = _sp2_jong_core(
                sys, warr[:, 0:1], rmin, p, B, max_iters=sp2_iters)
        # recompute f against the achieved transmission time
        tt_new = sys.bits / torch.clamp_min(_rate(sys, B_new, p_new), 1e-12)
        f = torch.minimum(torch.maximum(
            en.cycles_per_round(sys, s)
            / torch.clamp_min(T_round - tt_new, 1e-9), sys.f_min), sys.f_max)
        alloc = Allocation(bandwidth=B_new, power=p_new, freq=f, resolution=s,
                           T=T_round)
        metrics = tuple(m[:, 0] for m in (
            en.total_energy(sys, alloc), en.total_time(sys, alloc),
            en.total_accuracy(acc, alloc, sys.active)))
        return (B_new, p_new, f, s, s_hat, T_round), metrics + (ev.to(dtype),)

    out = _bcd_while(state0, max_iters, len(_FIXED_COLS), tol, step,
                     mask=sys.active)
    counters = _pack_counters(out[6], out[8], max_iters,
                              _FIXED_COLS.index("sp2_evals"),
                              _FIXED_COLS.index("rel_step"), 0)
    return (*out, counters)


def _materialize_history(ledger: np.ndarray, iters: int,
                         cols: Sequence[str]) -> List[dict]:
    out = []
    for i in range(iters):
        row = dict(iter=i + 1)
        for c, v in zip(cols, ledger[i]):
            row[c] = int(v) if c in ("sp2_iters", "sp2_evals") else float(v)
        out.append(row)
    return out


def stack_systems(systems: Sequence[SystemParams]) -> SystemParams:
    """Stack single-cell systems into one (C, N) system with (C, 1)
    per-cell scalars. Cells may differ in any numeric scalar; the discrete
    resolution menu must match. If any cell carries an `active` mask,
    cells without one get an all-True mask."""
    menu = systems[0].resolutions
    if any(s_.resolutions != menu for s_ in systems[1:]):
        raise ValueError(
            "stack_systems: cells differ in static config (resolutions)")
    stacked = {k: torch.stack([getattr(s_, k) for s_ in systems])
               for k in SYS_ARRAYS}
    stacked.update({k: torch.stack([getattr(s_, k).reshape(1)
                                    for s_ in systems])
                    for k in SYS_SCALARS})
    active = None
    if any(s_.active is not None for s_ in systems):
        active = torch.stack([
            s_.active if s_.active is not None
            else torch.ones(s_.gain.shape, dtype=torch.bool,
                            device=s_.gain.device) for s_ in systems])
    return SystemParams(**stacked, resolutions=menu, active=active)


def _fleet_result(out, max_iters: int,
                  cols: Sequence[str] = _LEDGER_COLS) -> FleetResult:
    """Assemble a FleetResult from the raw `_allocate_impl` (or, with
    cols=_FIXED_COLS, `_allocate_fixed_impl`) outputs. Ledger column 0 is
    the per-cell objective in both ("objective" / "energy")."""
    B, p, f, s, s_hat, T, iters, conv, ledger, counters = out
    if max_iters > 0:
        idx = torch.clamp(iters.long() - 1, 0, max_iters - 1)
        last = ledger[..., 0].gather(-1, idx[:, None])[:, 0]
        objective = torch.where(iters > 0, last, torch.full_like(last,
                                                                 float("nan")))
    else:
        objective = torch.full(iters.shape, float("nan"), dtype=B.dtype,
                               device=B.device)
    allocation = Allocation(bandwidth=B, power=p, freq=f, resolution=s,
                            s_relaxed=s_hat if cols is _LEDGER_COLS else None,
                            T=T[:, 0])
    return FleetResult(allocation=allocation, objective=objective,
                       iters=iters, converged=conv, history=ledger,
                       columns=tuple(cols),
                       counters=SolveCounters(data=counters))
