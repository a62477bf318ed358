"""Round-dynamics engine: R global rounds of sampled channels, warm-started
re-allocation and participation.

Port of `repro/dynamics/engine.py`. The reference runs the rounds as one
`lax.scan` under `jax.vmap` over cells; here one Python loop over rounds
runs every cell of a (C, N) stack at once. Per round it

  1. realizes the channel (`core.channel.sample_gain`, or the AR(1)
     Gauss-Markov drift `core.channel.drift_shadowing`),
  2. re-solves the allocation with the BCD (`core.bcd._allocate_impl`),
     warm-started from the last round's state, so the SP1 kernel
     `sp1_lambda_sum` runs 3 times per batched BCD iteration of the round,
  3. applies the participation model (straggler deadline misses, random
     dropouts, async staleness; see `dynamics.participation`), and
  4. writes the round's realized energy / time / accuracy ledger row.

Draws are inputs. The engine reads only a `RoundDraws`: the initial Markov
state, one standard normal per round and device (the iid shadowing draw,
or the Markov innovation), and the dropout mask. `draws_from_generator`
makes them from a `torch.Generator`; `interop.round_draws_from_numpy`
carries the reference's `jax.random` draws over for the parity tests.
The reference's deprecated shims `run_rounds` / `run_rounds_fleet` are not
ported: `repro_torch.solve(Problem(rounds=..., key=...))` is the entry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import energy as en
from ..core.accuracy import AccuracyModel
from ..core.bcd import (_COUNTER_COLS, _allocate_impl, _init_carry_state,
                        initial_allocation)
from ..core.channel import (GeneratorLike, _generator, drift_shadowing,
                            sample_gain, shadowing_to_gain)
from ..core.types import Allocation, SystemParams, Weights, resolve_device
from .config import ROUND_COLS, RoundsConfig, RoundsResult
from .participation import queue_step, staleness_of

Tensor = torch.Tensor


@dataclasses.dataclass
class RoundDraws:
    """Every random draw of a rounds run, per cell.

    shadow0: (C, N) the initial Markov shadowing state (zeros unless
        channel_mode == "markov").
    z: (C, R, N) one standard normal per round and device: the iid
        shadowing draw ("iid") or the AR(1) innovation ("markov"); unread
        under "static".
    drop: (C, R, N) bool, the dropout mask (all False when
        dropout_prob == 0).
    A single cell may give (N,) / (R, N) tensors (C = 1)."""
    shadow0: Tensor
    z: Tensor
    drop: Tensor

    def to(self, device=None, dtype: Optional[torch.dtype] = None
           ) -> "RoundDraws":
        return RoundDraws(shadow0=self.shadow0.to(device=device, dtype=dtype),
                          z=self.z.to(device=device, dtype=dtype),
                          drop=self.drop.to(device=device))


def draws_from_generator(gen: GeneratorLike, C: int, R: int,
                         N: int, cfg: RoundsConfig, device=None,
                         dtype: torch.dtype = torch.float32) -> RoundDraws:
    """The draws of a C-cell, R-round, N-device run from `gen` (a
    `torch.Generator` on `device`, or an integer seed for one), on
    `device` (CUDA by default)."""
    device = resolve_device(device)
    gen = _generator(gen, device)

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    shadow0 = normal((C, N)) if cfg.channel_mode == "markov" \
        else torch.zeros((C, N), dtype=dtype, device=device)
    z = normal((C, R, N)) if cfg.channel_mode != "static" \
        else torch.zeros((C, R, N), dtype=dtype, device=device)
    if cfg.dropout_prob > 0.0:
        drop = torch.rand((C, R, N), generator=gen, dtype=dtype,
                          device=device) < cfg.dropout_prob
    else:
        drop = torch.zeros((C, R, N), dtype=torch.bool, device=device)
    return RoundDraws(shadow0=shadow0, z=z, drop=drop)


def round_draws(key, sys: SystemParams, cfg: RoundsConfig) -> RoundDraws:
    """`Problem.key` of a rounds problem as (C, R, N) draws on the batched
    system's device and in its dtype: a `RoundDraws` (a single cell's may
    lack the cell axis), a `torch.Generator`, or an integer seed."""
    C, N = sys.gain.shape
    R = cfg.rounds
    if not isinstance(key, RoundDraws):
        return draws_from_generator(key, C, R, N, cfg, sys.device, sys.dtype)
    d = key.to(sys.device, sys.dtype)
    if d.z.ndim == 2:
        d = RoundDraws(d.shadow0.reshape(1, -1), d.z[None], d.drop[None])
    want = {"shadow0": (C, N), "z": (C, R, N), "drop": (C, R, N)}
    for name, shape in want.items():
        got = tuple(getattr(d, name).shape)
        if got != shape:
            raise ValueError(f"RoundDraws.{name} has shape {got}, the "
                             f"problem needs {shape}")
    return d


def _masked_max(x: Tensor, mask: Tensor) -> Tensor:
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device)).amax(-1)


def _masked_sum(x: Tensor, mask: Tensor) -> Tensor:
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device)).sum(-1)


def run_engine(sys: SystemParams, warr: Tensor, acc: AccuracyModel,
               draws: RoundDraws, state0, cfg: RoundsConfig):
    """Every cell's R rounds on a batched system, warr (C, 3). Returns
    (final BCD state, ledger (C, R, cols), staleness codes (C, R, N) int32,
    realized gains (C, R, N), allocated resolutions (C, R, N))."""
    dtype = state0[0].dtype
    C, N = sys.gain.shape
    K = cfg.max_staleness
    zero = torch.zeros((), dtype=dtype, device=sys.device)
    Dw = sys.samples.to(dtype)
    w_total = torch.clamp_min(Dw.sum(-1), torch.finfo(dtype).tiny)
    wobj = Weights(warr[:, 0:1], warr[:, 1:2], warr[:, 2:3])
    decay = torch.as_tensor(cfg.staleness_decay, dtype=dtype,
                            device=sys.device)
    shadow = draws.shadow0
    qw = qu = torch.zeros((C, K), dtype=dtype, device=sys.device)
    state = state0
    rows, codes, gains, res = [], [], [], []
    for r in range(cfg.rounds):
        # (1) channel realization for this round
        if cfg.channel_mode == "static":
            g = sys.gain
        elif cfg.channel_mode == "iid":
            g = sample_gain(sys.gain, draws.z[:, r], cfg.shadowing_db)
        else:  # markov
            shadow = drift_shadowing(shadow, draws.z[:, r], cfg.drift_rho)
            g = shadowing_to_gain(sys.gain, shadow, cfg.shadowing_db)
        sys_r = sys.replace(gain=g)

        # (2) warm-started re-allocation (bcd_iters=0 keeps the carried init)
        state_in = state if cfg.warm_start else _init_carry_state(
            sys_r, initial_allocation(sys_r))
        B, p, f, s, s_hat, T, iters, conv, _, counters = _allocate_impl(
            sys_r, warr, acc, state_in, cfg.bcd_iters, cfg.bcd_tol,
            cfg.sp1_method, cfg.sp2_method, cfg.sp2_iters)
        state = (B, p, f, s, s_hat, T)
        alloc = Allocation(bandwidth=B, power=p, freq=f, resolution=s,
                           s_relaxed=s_hat, T=T)

        # realized per-device round time / energy under this round's gains
        t_dev = (en.t_cmp(sys_r, f, s) + en.t_trans(sys_r, B, p)).to(dtype)
        e_dev = (en.e_cmp(sys_r, f, s) + en.e_trans(sys_r, B, p)).to(dtype)
        util_dev = acc.value(s).to(dtype)

        # (3) participation
        active = ~draws.drop[:, r]
        if sys.active is not None:   # padded-out lanes never participate
            active = active & sys.active
        deadline = cfg.deadline_slack * T                      # (C, 1)

        if cfg.participation == "full":
            late = torch.zeros_like(active)
            arrived_u = _masked_sum(util_dev, active)
            arrived_w = _masked_sum(Dw, active)
            time_r = _masked_max(t_dev, active)
            code = torch.where(active, 0, -1).to(torch.int32)
        else:
            # lateness and the queued staleness come from one bucketing, so
            # a one-ulp-late device cannot read late with staleness 0
            kst = staleness_of(t_dev, deadline, K)
            late = active & (kst > 0)
            ontime = active & ~late
            closes_at = torch.where(late.any(-1), deadline[:, 0],
                                    _masked_max(t_dev, ontime))
            if cfg.participation == "drop":
                arrived_u = _masked_sum(util_dev, ontime)
                arrived_w = _masked_sum(Dw, ontime)
                code = torch.where(ontime, 0, -1).to(torch.int32)
            else:  # stale: late mass arrives k rounds later, decay^k weighted
                disc = decay ** kst.to(dtype)
                qw, qu, pop_w, pop_u = queue_step(
                    qw, qu, torch.clamp_min(kst - 1, 0),
                    torch.where(late, Dw * disc, zero),
                    torch.where(late, util_dev * disc, zero))
                arrived_u = _masked_sum(util_dev, ontime) + pop_u
                arrived_w = _masked_sum(Dw, ontime) + pop_w
                code = torch.where(active, torch.where(late, kst, 0),
                                   -1).to(torch.int32)
            time_r = closes_at

        # (4) realized ledger row
        rows.append(torch.stack([
            en.objective(sys_r, wobj, acc, alloc)[:, 0].to(dtype),
            _masked_sum(e_dev, active),
            time_r,
            arrived_u,
            arrived_w / w_total,
            late.sum(-1).to(dtype),
            (~active).sum(-1).to(dtype),
            iters.to(dtype),
            conv.to(dtype),
            # the round's SP2 dual-eval effort (ROUND_COLS "sp2_evals")
            counters[:, _COUNTER_COLS.index("sp2_evals")].to(dtype),
        ], -1))
        codes.append(code)
        gains.append(g.to(dtype))
        res.append(s)
    return (state, torch.stack(rows, 1), torch.stack(codes, 1),
            torch.stack(gains, 1), torch.stack(res, 1))


def rounds_result(out, single: bool) -> RoundsResult:
    """A RoundsResult from `run_engine`'s outputs; `single` drops the cell
    axis of a one-cell problem."""
    state, ledger, codes, gains, res = out
    B, p, f, s, s_hat, T = state
    alloc = Allocation(bandwidth=B, power=p, freq=f, resolution=s,
                       s_relaxed=s_hat, T=T[:, 0])
    if single:
        alloc = Allocation(**{f.name: getattr(alloc, f.name)[0]
                              for f in dataclasses.fields(alloc)})
        ledger, codes, gains, res = ledger[0], codes[0], gains[0], res[0]
    return RoundsResult(allocation=alloc, ledger=ledger, staleness=codes,
                        gains=gains, resolutions=res, columns=ROUND_COLS)


def check_simulation_init(cfg: RoundsConfig, init: Optional[Allocation]):
    """bcd_iters=0 never solves, so the straggler deadline comes entirely
    from the init's makespan T: without one, deadline=0 and every device
    would silently read as late every round."""
    if (cfg.bcd_iters == 0 and cfg.participation != "full"
            and (init is None or init.T is None)):
        raise ValueError(
            "rounds: bcd_iters=0 with a straggler participation model "
            f"({cfg.participation!r}) needs an init allocation carrying a "
            "makespan T (e.g. BCDResult.allocation from solve)")
