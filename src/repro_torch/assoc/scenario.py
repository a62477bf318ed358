"""Geometry-consistent multi-cell scenarios for cross-cell association.

Port of `repro/assoc/scenario.py`. `make_fleet` draws C *independent*
cells; cross-cell association needs one shared geometry, where every
device has a gain to EVERY cell, correlated through its position.
`make_multicell` builds that stacked (C, N) system: devices uniform over
the region, base stations on a grid (`bs_grid`, the port's one copy in
`dynamics.mobility`), row c = the expected pathloss + shadowing gain of
all N devices to cell c, device attributes (cycles / samples / bits)
shared across rows, per-cell scalars broadcast (or overridden per cell).

The draws are inputs: `make_multicell` takes the device `positions` and
the single-cell `base` system, or draws both from a `torch.Generator`
(`core.channel`'s draws, not `jax.random`'s); parity tests hand it the
reference's through `interop`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.channel import (GeneratorLike, _generator, device_positions,
                            make_system, pathloss_db, shadowing_sigma)
from ..core.types import SYS_SCALARS, SystemParams
from ..dynamics.mobility import _norm, bs_grid

Tensor = torch.Tensor

__all__ = ["bs_grid", "cross_gains", "make_multicell"]


def cross_gains(positions: Tensor, bs_xy: Tensor,
                shadowing_db: float) -> Tensor:
    """(..., C, N) expected gains of devices at `positions` (..., N, 2) to
    base stations `bs_xy` (C, 2): pathloss with the lognormal shadowing
    mean folded in, exactly `core.channel.expected_gain`'s model."""
    bs_xy = bs_xy.to(device=positions.device, dtype=positions.dtype)
    d = _norm(positions[..., None, :, :] - bs_xy[:, None, :])   # (..., C, N)
    sigma = torch.tensor(shadowing_sigma(shadowing_db),
                         dtype=positions.dtype, device=positions.device)
    return 10.0 ** (-pathloss_db(d) / 10.0) * torch.exp(sigma ** 2 / 2.0)


def make_multicell(gen: Optional[GeneratorLike], n_cells: int,
                   n_devices: int, area_m: float = 1000.0,
                   positions: Optional[Tensor] = None, *,
                   base: Optional[SystemParams] = None, device=None,
                   dtype: torch.dtype = torch.float32,
                   **overrides) -> SystemParams:
    """Stacked (C, N) system over one shared device geometry.

    Any `make_system` scalar override may also be a length-C sequence to
    make the cells heterogeneous (e.g. ``bandwidth_total=[10e6, 40e6]``,
    the capacity pressure that makes association bite). Device attributes
    come from one single-cell system, shared across rows: `base` if given
    (its device and dtype are kept; scalar overrides must then be per
    cell), else `make_system(gen, n_devices, area_m=area_m, **overrides)`
    on `device` in `dtype`. `positions` (N, 2) are drawn from `gen` after
    the base system when not given.
    """
    per_cell = {}
    for k, v in list(overrides.items()):
        if isinstance(v, torch.Tensor):
            v = v.tolist()
        if isinstance(v, (list, tuple, np.ndarray)) and k != "resolutions" \
                and np.ndim(v) > 0:
            vals = [float(x) for x in np.asarray(v).ravel()]
            if len(vals) != n_cells:
                raise ValueError(
                    f"make_multicell: per-cell override {k!r} has "
                    f"{len(vals)} entries for {n_cells} cells")
            per_cell[k] = vals
            del overrides[k]
    shadowing_db = float(overrides.pop("shadowing_db", 8.0))
    if gen is None and (base is None or positions is None):
        raise ValueError("make_multicell: give a generator, or both the "
                         "base system and the positions")
    gen = None if gen is None else _generator(gen)
    if base is None:
        base = make_system(gen, n_devices=n_devices, area_m=area_m,
                           device=device, dtype=dtype,
                           shadowing_db=shadowing_db, **overrides)
    elif overrides:
        raise ValueError(
            f"make_multicell: overrides {sorted(overrides)} would not "
            f"reach the given base system (give them per cell)")
    if base.n != n_devices or base.cells is not None:
        raise ValueError(f"make_multicell: base must be one cell of "
                         f"{n_devices} devices")
    if positions is None:
        positions = device_positions(gen, n_devices, area_m)
    dt, dev = base.dtype, base.device
    gain = cross_gains(torch.as_tensor(positions).to(device=dev, dtype=dt),
                       bs_grid(n_cells, area_m, dt, dev), shadowing_db)

    def col(name):
        if name in per_cell:
            return torch.tensor(per_cell[name], dtype=dt,
                                device=dev).reshape(n_cells, 1)
        return torch.broadcast_to(getattr(base, name).reshape(1, 1),
                                  (n_cells, 1)).clone()

    def rep(x):
        return torch.broadcast_to(x, (n_cells, n_devices)).clone()

    return SystemParams(
        gain=gain, cycles=rep(base.cycles), samples=rep(base.samples),
        bits=rep(base.bits), resolutions=base.resolutions,
        **{k: col(k) for k in SYS_SCALARS})
