"""Mobility traces: moving devices and their gains to every cell.

Port of `repro/dynamics/mobility.py` (without `replay_mobility`, which
drives the region serving pipeline: ROADMAP Queue 1 item 9).

  * position models, one loop over steps each:
      - "rwp": random waypoint: walk to a uniform waypoint at a uniform
        speed, then draw the next;
      - "gauss_markov": AR(1) velocity (memory `alpha`), walls reflecting;
  * gains: positions -> distance to every base station -> pathloss
    (128.1 + 37.6 log10 d_km) with AR(1) lognormal shadowing per
    (cell, device) link (`drift_rho`, `core.channel.drift_shadowing`);
  * events: per-step serving cell (argmax gain) and handover flags.

Draws are inputs: every function reads a `MobilityDraws`, which
`mobility_draws` makes from a `torch.Generator` and
`interop.mobility_draws_from_numpy` fills with the reference's draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

from ..core.channel import (GeneratorLike, _generator, drift_shadowing,
                            pathloss_db, shadowing_sigma)
from ..core.types import resolve_device

Tensor = torch.Tensor

_MODELS = ("rwp", "gauss_markov")


@dataclasses.dataclass(frozen=True)
class MobilityConfig:
    """The knobs of a mobility trace.

    model : "rwp" (random waypoint) or "gauss_markov" (AR(1) velocity).
    steps / dt : trace length R and seconds per step.
    area_m : side of the centered square region (devices stay inside).
    v_min, v_max : waypoint leg speeds (rwp), m/s.
    alpha / v_sigma : Gauss-Markov velocity memory and asymptotic per-axis
        speed std (m/s).
    shadowing_db : lognormal shadowing std in dB (0 = pure pathloss).
    drift_rho : per-step AR(1) correlation of the shadowing state.
    """
    model: str = "rwp"
    steps: int = 50
    dt: float = 1.0
    area_m: float = 1000.0
    v_min: float = 0.5
    v_max: float = 2.0
    alpha: float = 0.85
    v_sigma: float = 1.5
    shadowing_db: float = 8.0
    drift_rho: float = 0.9

    def __post_init__(self):
        if self.model not in _MODELS:
            raise ValueError(f"MobilityConfig: model must be one of "
                             f"{_MODELS}, got {self.model!r}")
        if self.steps < 1:
            raise ValueError("MobilityConfig: steps must be >= 1")
        if not (0.0 < self.v_min <= self.v_max):
            raise ValueError("MobilityConfig: need 0 < v_min <= v_max")
        if not (0.0 <= self.alpha <= 1.0 and 0.0 <= self.drift_rho <= 1.0):
            raise ValueError("MobilityConfig: alpha/drift_rho in [0, 1]")
        if self.dt <= 0 or self.area_m <= 0 or self.v_sigma < 0 \
                or self.shadowing_db < 0:
            raise ValueError("MobilityConfig: dt/area_m/v_sigma/"
                             "shadowing_db out of range")


@dataclasses.dataclass
class MobilityDraws:
    """Every random draw of one trace of N devices, R steps, C cells.

    pos0: (N, 2) uniform [0, 1): the start positions.
    v0: "rwp": (N,) uniform, the first leg's speed; "gauss_markov": (N, 2)
        standard normal, the start velocity over v_sigma.
    step_xy: (R, N, 2) per step: "rwp": uniform, the next waypoint (read
        where a device arrives); "gauss_markov": standard normal, the
        velocity innovation.
    wp0 / step_v: "rwp" only: (N, 2) uniform first waypoints and (R, N)
        uniform next-leg speeds.
    shadow0 / shadow_z: the link shadowing: (C, N) the first step's
        standard-normal state and (R - 1, C, N) the AR(1) innovations
        (None when shadowing_db == 0)."""
    pos0: Tensor
    v0: Tensor
    step_xy: Tensor
    wp0: Optional[Tensor] = None
    step_v: Optional[Tensor] = None
    shadow0: Optional[Tensor] = None
    shadow_z: Optional[Tensor] = None

    def to(self, device=None, dtype=None) -> "MobilityDraws":
        return MobilityDraws(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class MobilityTrace:
    """One realized trace. Rows are post-step snapshots r = 0..R-1."""
    positions: Tensor  # (R, N, 2) meters, centered region
    gains: Tensor      # (R, C, N) realized linear gains to every cell
    serving: Tensor    # (R, N) int32 argmax-gain serving cell
    handover: Tensor   # (R, N) bool, serving changed vs previous row
    bs_xy: Tensor      # (C, 2) base-station positions

    @property
    def steps(self) -> int:
        return int(self.positions.shape[0])

    @property
    def n_cells(self) -> int:
        return int(self.gains.shape[1])


def bs_grid(n_cells: int, area_m: float, dtype=torch.float32,
            device=None) -> Tensor:
    """(C, 2) base-station positions on a centered square grid covering
    [-area/2, area/2]^2 (C=1 puts the single BS at the origin). The port's
    copy of `repro/assoc/scenario.py::bs_grid`."""
    if n_cells < 1:
        raise ValueError("bs_grid: n_cells must be >= 1")
    g = int(np.ceil(np.sqrt(n_cells)))
    idx = np.arange(n_cells)
    xs = ((idx % g) + 0.5) / g * area_m - area_m / 2.0
    ys = ((idx // g) + 0.5) / g * area_m - area_m / 2.0
    return torch.as_tensor(np.stack([xs, ys], axis=-1), dtype=dtype,
                           device=device)


def mobility_draws(gen: GeneratorLike, n: int, n_cells: int,
                   cfg: MobilityConfig, device=None,
                   dtype: torch.dtype = torch.float32) -> MobilityDraws:
    """A trace's draws from `gen` (a `torch.Generator` on `device`, or an
    integer seed for one), on `device` (CUDA by default)."""
    device = resolve_device(device)
    gen = _generator(gen, device)
    R = cfg.steps

    def u(*shape):
        return torch.rand(shape, generator=gen, dtype=dtype, device=device)

    def z(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    if cfg.model == "rwp":
        d = MobilityDraws(pos0=u(n, 2), wp0=u(n, 2), v0=u(n),
                          step_xy=u(R, n, 2), step_v=u(R, n))
    else:
        d = MobilityDraws(pos0=u(n, 2), v0=z(n, 2), step_xy=z(R, n, 2))
    if cfg.shadowing_db != 0.0:
        d.shadow0, d.shadow_z = z(n_cells, n), z(R - 1, n_cells, n)
    return d


def _norm(x: Tensor) -> Tensor:
    """Euclidean norm over the last axis, sqrt(sum x^2), as jnp's."""
    return torch.sqrt((x * x).sum(-1))


def _rwp_positions(d: MobilityDraws, cfg: MobilityConfig) -> Tensor:
    half = cfg.area_m / 2.0
    pos = (d.pos0 - 0.5) * cfg.area_m
    wp = (d.wp0 - 0.5) * cfg.area_m
    v = cfg.v_min + (cfg.v_max - cfg.v_min) * d.v0
    tiny = torch.tensor(1e-12, dtype=pos.dtype, device=pos.device)
    dt = torch.tensor(cfg.dt, dtype=pos.dtype, device=pos.device)
    out = []
    for r in range(cfg.steps):
        delta = wp - pos
        dist = _norm(delta)
        leg = v * dt
        frac = torch.minimum(leg, dist) / torch.maximum(dist, tiny)
        pos = pos + delta * frac[:, None]
        arrive = dist <= leg
        wp = torch.where(arrive[:, None], (d.step_xy[r] - 0.5) * cfg.area_m,
                         wp)
        v = torch.where(arrive, cfg.v_min + (cfg.v_max - cfg.v_min)
                        * d.step_v[r], v)
        pos = torch.clamp(pos, -half, half)
        out.append(pos)
    return torch.stack(out)


def _gm_positions(d: MobilityDraws, cfg: MobilityConfig) -> Tensor:
    dtype, device = d.pos0.dtype, d.pos0.device
    half = torch.tensor(cfg.area_m / 2.0, dtype=dtype, device=device)
    pos = (d.pos0 - 0.5) * cfg.area_m
    v = cfg.v_sigma * d.v0
    a = torch.tensor(cfg.alpha, dtype=dtype, device=device)
    sig = torch.tensor(cfg.v_sigma * math.sqrt(max(1.0 - cfg.alpha ** 2,
                                                   0.0)),
                       dtype=dtype, device=device)
    dt = torch.tensor(cfg.dt, dtype=dtype, device=device)
    out = []
    for r in range(cfg.steps):
        v = a * v + sig * d.step_xy[r]
        nxt = pos + v * dt
        hit = (nxt > half) | (nxt < -half)
        nxt = torch.where(nxt > half, 2.0 * half - nxt, nxt)
        nxt = torch.where(nxt < -half, -2.0 * half - nxt, nxt)
        nxt = torch.minimum(torch.maximum(nxt, -half), half)  # overshoot guard
        v = torch.where(hit, -v, v)                           # reflect the wall
        pos = nxt
        out.append(pos)
    return torch.stack(out)


def _shadow_states(x0: Tensor, zs: Tensor, rho: float) -> Tensor:
    """(R, C, N) AR(1) standard-normal shadowing states: row 0 is the
    stationary draw x0, each next row one `drift_shadowing` step."""
    xs = [x0]
    for z in zs:
        xs.append(drift_shadowing(xs[-1], z, rho))
    return torch.stack(xs)


def trace_gains(positions: Tensor, bs_xy: Tensor, cfg: MobilityConfig,
                draws: Optional[MobilityDraws] = None) -> Tensor:
    """(R, C, N) realized gains: pathloss at each step's distances times
    AR(1)-correlated lognormal shadowing per (cell, device) link, from the
    draws' shadow0 / shadow_z (unread when shadowing_db == 0)."""
    dtype = positions.dtype
    bs_xy = bs_xy.to(device=positions.device, dtype=dtype)
    dist = _norm(positions[:, None, :, :] - bs_xy[None, :, None, :])
    base = 10.0 ** (-pathloss_db(dist) / 10.0)
    if cfg.shadowing_db == 0.0:
        return base
    if draws is None or draws.shadow0 is None:
        raise ValueError("trace_gains: shadowing needs draws with shadow0 "
                         "and shadow_z")
    x = _shadow_states(draws.shadow0, draws.shadow_z, cfg.drift_rho)
    sigma = torch.tensor(shadowing_sigma(cfg.shadowing_db), dtype=dtype,
                         device=positions.device)
    return base * torch.exp(sigma * x)


def simulate_mobility(key: Union[MobilityDraws, GeneratorLike],
                      n_devices: int, n_cells: int = 1,
                      cfg: Optional[MobilityConfig] = None,
                      bs_xy: Optional[Tensor] = None,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> MobilityTrace:
    """One mobility trace: R steps of N devices across C cells, on
    `device` (CUDA by default). `key` is the trace's `MobilityDraws`, or a
    `torch.Generator` / integer seed to draw them from; the same draws
    give the same trace. `bs_xy` defaults to the centered `bs_grid`."""
    cfg = cfg if cfg is not None else MobilityConfig()
    dev = resolve_device(device)
    draws = key.to(dev, dtype) if isinstance(key, MobilityDraws) \
        else mobility_draws(key, int(n_devices), n_cells, cfg, dev, dtype)
    if bs_xy is None:
        bs_xy = bs_grid(n_cells, cfg.area_m, dtype, dev)
    bs_xy = torch.as_tensor(bs_xy, dtype=dtype).to(dev)
    if tuple(bs_xy.shape) != (n_cells, 2):
        raise ValueError(f"simulate_mobility: bs_xy must be ({n_cells}, 2),"
                         f" got {tuple(bs_xy.shape)}")
    if tuple(draws.pos0.shape) != (int(n_devices), 2):
        raise ValueError(f"simulate_mobility: draws are for "
                         f"{draws.pos0.shape[0]} devices, not {n_devices}")
    mover = _rwp_positions if cfg.model == "rwp" else _gm_positions
    pos = mover(draws, cfg)
    gains = trace_gains(pos, bs_xy, cfg, draws)
    serving = gains.argmax(1).to(torch.int32)                 # (R, N)
    prev = torch.cat([serving[:1], serving[:-1]], 0)
    return MobilityTrace(positions=pos, gains=gains, serving=serving,
                         handover=serving != prev, bs_xy=bs_xy)
