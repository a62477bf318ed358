"""Wireless channel substrate (paper §VII-A).

Port of `repro/core/channel.py`. Pathloss model: 128.1 + 37.6 log10(d_km)
dB plus 8 dB lognormal shadow fading; devices uniform in a square area
with the base station at the center; FDMA uplink; N0 = -174 dBm/Hz. The
paper optimizes against the *expected* channel gain E[G_n] (Jensen's
inequality, §III-B).

Draws come from an explicit `torch.Generator` on the CPU, in float64, and
are then cast and moved: the same seed gives the same system on every
device. They are not `jax.random`'s numbers; parity tests build their
systems with `repro` and bring them over through `repro_torch.interop`.

The round-to-round channel (`shadowing_to_gain`, `sample_gain`,
`drift_shadowing`) takes its standard-normal draw `z` as a tensor, so a
caller can feed it any draws: the reference's, through `interop`, or a
`torch.Generator`'s, through `dynamics.draws_from_generator`.
"""
from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch

from .types import DEFAULTS, SYS_SCALARS, SystemParams, resolve_device

Tensor = torch.Tensor
GeneratorLike = Union[torch.Generator, int]


def _generator(gen: GeneratorLike, device=None) -> torch.Generator:
    """`gen` itself, or a generator on `device` (the CPU by default)
    seeded with the integer `gen`."""
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator(device=device).manual_seed(int(gen))


def device_positions(gen: torch.Generator, n: int, area_m: float) -> Tensor:
    """Uniform positions in [-area/2, area/2]^2; BS at origin. (n, 2) meters."""
    return (torch.rand((n, 2), generator=gen, dtype=torch.float64) - 0.5) \
        * area_m


def pathloss_db(distance_m: Tensor) -> Tensor:
    d_km = torch.clamp_min(distance_m, 1.0) / 1000.0
    return 128.1 + 37.6 * torch.log10(d_km)


def shadowing_sigma(shadowing_db: float) -> float:
    """Natural-log sigma of the lognormal shadow fading (sigma_dB -> ln)."""
    return shadowing_db * math.log(10.0) / 10.0


def shadowing_to_gain(expected: Tensor, x: Tensor,
                      shadowing_db: float) -> Tensor:
    """Map a standard-normal shadowing state x to a gain realization.

    `expected` already folds in the lognormal mean E[10^(X/10)] (see
    `expected_gain`), so it is divided back out before the realization is
    applied: E_x[shadowing_to_gain(expected, x, db)] == expected."""
    sigma = torch.as_tensor(shadowing_sigma(shadowing_db), dtype=x.dtype,
                            device=x.device)
    shadow_mean = torch.exp(sigma * sigma / 2.0)
    return expected / shadow_mean * torch.exp(sigma * x)


def sample_gain(expected: Tensor, z: Tensor, shadowing_db: float) -> Tensor:
    """One iid realization g_{n,r} of the channel for a global round, from
    the standard-normal draw z (shaped like `expected`)."""
    return shadowing_to_gain(expected, z, shadowing_db)


def drift_shadowing(x: Tensor, z: Tensor, rho: float) -> Tensor:
    """One AR(1) Gauss-Markov step of the standard-normal shadowing state:
    x' = rho x + sqrt(1 - rho^2) z, z ~ N(0, 1) (round-to-round correlated
    fading). The stationary law stays N(0, 1), so `shadowing_to_gain`
    keeps E[gain] == expected at every round."""
    rho = torch.as_tensor(rho, dtype=x.dtype, device=x.device)
    return rho * x + torch.sqrt(torch.clamp_min(1.0 - rho * rho, 0.0)) * z


def expected_gain(gen: torch.Generator, n: int, area_m: float,
                  shadowing_db: float) -> Tensor:
    """E[G_n]: linear-scale expected gain with lognormal shadowing.

    For shadowing X ~ N(0, sigma^2) in dB, E[10^(X/10)] =
    exp((sigma ln10/10)^2/2); that factor is folded into the expectation
    rather than sampled (the paper's use of E[G_n] in eqs. (1)-(2))."""
    dist = torch.linalg.vector_norm(device_positions(gen, n, area_m), dim=-1)
    shadow_mean = math.exp(shadowing_sigma(shadowing_db) ** 2 / 2.0)
    return 10.0 ** (-pathloss_db(dist) / 10.0) * shadow_mean


def make_system(gen: GeneratorLike = 0, n_devices: int | None = None, *,
                device=None, dtype: torch.dtype = torch.float32,
                **overrides) -> SystemParams:
    """A SystemParams with the paper's §VII-A parameterization, drawn from
    `gen` (a torch.Generator or an integer seed), on `device` (CUDA by
    default) in `dtype`."""
    dev = resolve_device(device)
    gen = _generator(gen)
    cfg = dict(DEFAULTS)
    cfg.update(overrides)
    n = int(n_devices if n_devices is not None else cfg["n_devices"])
    gain = expected_gain(gen, n, cfg["area_m"], cfg["shadowing_db"])
    cycles = cfg["cycles_lo"] + (cfg["cycles_hi"] - cfg["cycles_lo"]) \
        * torch.rand((n,), generator=gen, dtype=torch.float64)

    def t(x):
        return torch.as_tensor(x, dtype=dtype).to(dev)

    return SystemParams(
        gain=t(gain),
        cycles=t(cycles),
        samples=t(torch.full((n,), float(cfg["samples_per_device"]))),
        bits=t(torch.full((n,), float(cfg["upload_bits"]))),
        resolutions=tuple(float(s) for s in cfg["resolutions"]),
        **{k: t(float(cfg[k])) for k in SYS_SCALARS},
    )


def make_fleet(gen: GeneratorLike, n_cells: int, n_devices: int, *,
               device=None, dtype: torch.dtype = torch.float32,
               **overrides) -> SystemParams:
    """C independent cells drawn with the §VII-A parameterization from one
    generator, stacked into (C, N) device tensors and (C, 1) per-cell
    scalars.

    A scalar override given as a length-C sequence is distributed cell by
    cell, e.g. ``make_fleet(0, 3, 64, bandwidth_total=[10e6, 20e6, 40e6])``
    builds a fleet of three different cell classes."""
    from .bcd import stack_systems

    gen = _generator(gen)
    per_cell = {}
    for k, v in list(overrides.items()):
        if isinstance(v, torch.Tensor):
            v = v.tolist()
        if k != "resolutions" and isinstance(v, (list, tuple, np.ndarray)) \
                and np.ndim(v) > 0:
            vals = [float(x) for x in v]
            if len(vals) != n_cells:
                raise ValueError(
                    f"make_fleet: per-cell override {k!r} has {len(vals)} "
                    f"entries for {n_cells} cells")
            per_cell[k] = vals
            del overrides[k]
    return stack_systems([
        make_system(gen, n_devices=n_devices, device=device, dtype=dtype,
                    **{k: v[c] for k, v in per_cell.items()}, **overrides)
        for c in range(n_cells)])
