"""System model: rate, time, energy, and the paper's objective (eqs. 1-13).

Port of `repro/core/energy.py`. Reductions over devices keep the device
axis as size 1: on a (C, N) stack they return (C, 1), which broadcasts
against the (C, 1) per-cell scalars and weights; on one (N,) cell, (1,).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .accuracy import AccuracyModel
from .types import Allocation, SystemParams, Weights

Tensor = torch.Tensor


def log2(x: Tensor) -> Tensor:
    """log2 as log(x) * (1/ln2), the form XLA evaluates `jnp.log2` in:
    torch.log2 differs from it in the last bit on a share of inputs, and
    the solvers' bisections compare rates at the bit level."""
    return torch.log(x) * (1.0 / math.log(2.0))


def _masked(x: Tensor, active: Optional[Tensor]) -> Tensor:
    """Zero out padded-out devices before a sum/max reduction (time, energy
    and accuracy are nonnegative, so 0 is neutral for both)."""
    if active is None:
        return x
    return torch.where(active, x, torch.zeros((), dtype=x.dtype,
                                              device=x.device))


def _cell_sum(x: Tensor, active: Optional[Tensor]) -> Tensor:
    return _masked(x, active).sum(-1, keepdim=True)


def rate(sys: SystemParams, bandwidth: Tensor, power: Tensor) -> Tensor:
    """Shannon uplink rate r_n = B_n log2(1 + g_n p_n / (N0 B_n))  (eq. 1)."""
    b = torch.clamp_min(bandwidth, 1e-9)
    snr = sys.gain * power / (sys.noise_psd * b)
    return b * log2(1.0 + snr)


def t_trans(sys: SystemParams, bandwidth: Tensor, power: Tensor) -> Tensor:
    """Uplink transmission time per global round T_n^trans = d_n / r_n  (eq. 2)."""
    return sys.bits / torch.clamp_min(rate(sys, bandwidth, power), 1e-12)


def cycles_per_round(sys: SystemParams, resolution: Tensor) -> Tensor:
    """R_l * zeta * s_n^2 * c_n * D_n  (eqs. 7, 10): CPU cycles per global round."""
    return sys.local_iters * sys.zeta * (resolution * resolution) \
        * sys.cycles * sys.samples


def t_cmp(sys: SystemParams, freq: Tensor, resolution: Tensor) -> Tensor:
    """Local computation time per global round (eq. 10)."""
    return cycles_per_round(sys, resolution) / torch.clamp_min(freq, 1e-9)


def e_cmp(sys: SystemParams, freq: Tensor, resolution: Tensor) -> Tensor:
    """Local computation energy per global round (eq. 8)."""
    return sys.kappa * cycles_per_round(sys, resolution) * (freq * freq)


def e_trans(sys: SystemParams, bandwidth: Tensor, power: Tensor) -> Tensor:
    """Transmission energy per global round (eq. 3)."""
    return power * t_trans(sys, bandwidth, power)


def total_energy(sys: SystemParams, alloc: Allocation) -> Tensor:
    """E = R_g sum_n (E_trans + E_cmp)  (eq. 9). Padded devices excluded."""
    return sys.global_rounds * _cell_sum(
        e_trans(sys, alloc.bandwidth, alloc.power)
        + e_cmp(sys, alloc.freq, alloc.resolution), sys.active)


def round_time(sys: SystemParams, alloc: Allocation) -> Tensor:
    """Per-round makespan max_n (T_cmp + T_trans). Padded devices excluded."""
    return _masked(t_cmp(sys, alloc.freq, alloc.resolution)
                   + t_trans(sys, alloc.bandwidth, alloc.power),
                   sys.active).amax(-1, keepdim=True)


def total_time(sys: SystemParams, alloc: Allocation) -> Tensor:
    """T = R_g max_n (T_cmp + T_trans)  (eq. 11)."""
    return sys.global_rounds * round_time(sys, alloc)


def total_accuracy(acc: AccuracyModel, alloc: Allocation,
                   active: Optional[Tensor] = None) -> Tensor:
    """A = sum_n A_n(s_n)  (§III-C). `active` excludes padded devices."""
    return _cell_sum(acc.value(alloc.resolution), active)


def objective(sys: SystemParams, w: Weights, acc: AccuracyModel,
              alloc: Allocation) -> Tensor:
    """w1 E + w2 T - rho A  (eq. 12)."""
    return (w.w1 * total_energy(sys, alloc)
            + w.w2 * total_time(sys, alloc)
            - w.rho * total_accuracy(acc, alloc, sys.active))


def feasible(sys: SystemParams, alloc: Allocation, atol: float = 1e-6) -> bool:
    """Check constraints (12a)-(12d) for every cell."""
    b_ok = bool((alloc.bandwidth >= -atol).all()
                and (alloc.bandwidth.sum(-1, keepdim=True)
                     <= sys.bandwidth_total * (1 + 1e-6) + atol).all())
    p_ok = bool((alloc.power >= sys.p_min - atol).all()
                and (alloc.power <= sys.p_max * (1 + 1e-9) + atol).all())
    f_ok = bool((alloc.freq >= sys.f_min - atol).all()
                and (alloc.freq <= sys.f_max * (1 + 1e-9) + atol).all())
    res = torch.as_tensor(sys.resolutions, dtype=alloc.resolution.dtype,
                          device=alloc.resolution.device)
    s_ok = bool(((alloc.resolution[..., None] - res).abs().amin(-1)
                 < 1e-3).all())
    return b_ok and p_ok and f_ok and s_ok


def summarize(sys: SystemParams, w: Weights, acc: AccuracyModel,
              alloc: Allocation) -> dict:
    """Scalar metrics of one cell's allocation."""
    return dict(
        energy_J=float(total_energy(sys, alloc)),
        time_s=float(total_time(sys, alloc)),
        accuracy=float(total_accuracy(acc, alloc, sys.active)),
        objective=float(objective(sys, w, acc, alloc)),
        energy_trans_J=float(sys.global_rounds * e_trans(
            sys, alloc.bandwidth, alloc.power).sum(-1)),
        energy_cmp_J=float(sys.global_rounds * e_cmp(
            sys, alloc.freq, alloc.resolution).sum(-1)),
    )
