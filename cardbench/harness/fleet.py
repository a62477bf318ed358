"""Fleets of cells drawn from a seed, on the device, in a few large calls.

A frozen copy of the paper's §VII-A draws (the allocator's
`core/channel.py::make_system`): devices uniform in a square with the base
station at its centre, path loss 128.1 + 37.6 log10(d_km) dB with the
lognormal shadowing's mean folded into the expected gain, CPU cycles per
sample uniform in [cycles_lo, cycles_hi]. Drawn in float64 with a
`torch.Generator` on the device and then cast to the configuration's
dtype, so the same seed gives the same fleets on any card.
"""
from __future__ import annotations

import math

import torch

from reference.alg2 import System


def dbm_to_watt(dbm: float) -> float:
    return 10.0 ** (dbm / 10.0) * 1e-3


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` for any whole-number seed (taken mod 2^63)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def scalars(cfg: dict) -> dict:
    """The per-cell scalars of a configuration, SI units."""
    return dict(
        bandwidth_total=float(cfg["bandwidth_total_hz"]),
        noise_psd=dbm_to_watt(float(cfg["noise_psd_dbm_per_hz"])),
        p_min=dbm_to_watt(float(cfg["p_min_dbm"])),
        p_max=dbm_to_watt(float(cfg["p_max_dbm"])),
        f_min=float(cfg["f_min_hz"]), f_max=float(cfg["f_max_hz"]),
        kappa=float(cfg["kappa"]), local_iters=float(cfg["local_iters"]),
        global_rounds=float(cfg["global_rounds"]),
        s_standard=float(cfg["s_standard"]))


def draw(cfg: dict, n_fleets: int, gen: torch.Generator, device,
         dtype: torch.dtype) -> list:
    """`n_fleets` independent fleets of cfg["cells"] x
    cfg["devices_per_cell"] devices, each a reference `System` in `dtype`
    on `device`."""
    P, C, N = n_fleets, int(cfg["cells"]), int(cfg["devices_per_cell"])
    f64 = torch.float64
    pos = (torch.rand((P, C, N, 2), generator=gen, dtype=f64,
                      device=device) - 0.5) * float(cfg["area_m"])
    dist = torch.linalg.vector_norm(pos, dim=-1)
    del pos
    pl_db = 128.1 + 37.6 * torch.log10(torch.clamp_min(dist, 1.0) / 1000.0)
    sigma = float(cfg["shadowing_db"]) * math.log(10.0) / 10.0
    gain = (10.0 ** (-pl_db / 10.0) * math.exp(sigma * sigma / 2.0)).to(dtype)
    del dist, pl_db
    lo, hi = float(cfg["cycles_lo"]), float(cfg["cycles_hi"])
    cycles = (lo + (hi - lo) * torch.rand((P, C, N), generator=gen,
                                          dtype=f64, device=device)).to(dtype)
    samples = torch.full((C, N), float(cfg["samples_per_device"]),
                         dtype=dtype, device=device)
    bits = torch.full((C, N), float(cfg["upload_bits"]), dtype=dtype,
                      device=device)
    per_cell = {k: torch.full((C, 1), v, dtype=dtype, device=device)
                for k, v in scalars(cfg).items()}
    menu = tuple(float(s) for s in cfg["resolutions"])
    return [System(gain=gain[i], cycles=cycles[i], samples=samples,
                   bits=bits, resolutions=menu, **per_cell)
            for i in range(P)]
