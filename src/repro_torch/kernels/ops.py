"""Public entries of the port's kernels: the device picks the version.

Port of `repro/kernels/ops.py`. A CUDA tensor goes to the hand-written
kernel, and any failure there raises; a CPU tensor goes to the kernel's
plain PyTorch version. There is no switch and no fallback between them.
"""
from __future__ import annotations

import torch

from . import sp1_sweep, waterfill

Tensor = torch.Tensor


def sp1_lambda_sum(T_grid: Tensor, q: Tensor, tt: Tensor,
                   consts: Tensor) -> Tensor:
    """Batched SP1 dual sweep (used by `core.sp1`): Sigma_n lambda_n(T) for
    M candidate deadlines per cell. T_grid (C, M), q / tt (C, N),
    consts (C, sp1_sweep.N_CONSTS) -> (C, M), in the inputs' dtype."""
    if T_grid.device.type == "cuda":
        return sp1_sweep.sp1_lambda_sum(T_grid, q, tt, consts)
    if T_grid.device.type == "cpu":
        return sp1_sweep.sp1_lambda_sum_ref(T_grid, q, tt, consts)
    raise ValueError(f"sp1_lambda_sum: no kernel for device {T_grid.device}")


def waterfill_gprime(mu: Tensor, j: Tensor, rmin: Tensor,
                     B_total: Tensor) -> Tensor:
    """Batched SP2 dual sweep (used by `core.sp2`): g'(mu) (paper eq. A.23)
    for M candidate multipliers per cell. mu (C, M), j / rmin (C, N),
    B_total (C,) -> (C, M), in the inputs' dtype."""
    if mu.device.type == "cuda":
        return waterfill.waterfill_gprime(mu, j, rmin, B_total)
    if mu.device.type == "cpu":
        return waterfill.waterfill_gprime_ref(mu, j, rmin, B_total)
    raise ValueError(f"waterfill_gprime: no kernel for device {mu.device}")
