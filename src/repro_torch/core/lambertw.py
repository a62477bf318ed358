"""Principal-branch Lambert W (needed by SP2's dual, eq. A.22).

Port of `repro/core/lambertw.py`: W0(z) for z >= -1/e, from a
branch-aware initial guess and a fixed number of Halley steps; accurate to
~1e-12 in float64 across the domain the allocator uses.

Python constants take the tensor's dtype, as JAX's weak types do: in
float32 the guards 1e-300 and -1 + 1e-12 round to 0 and -1. That is the
reference's behaviour and it is kept as it is.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

_INV_E = -0.36787944117144233  # -1/e


def lambertw0(z: Tensor, iters: int = 24) -> Tensor:
    zc = torch.clamp_min(z, _INV_E)  # clamp below branch point (callers guard)

    # near the branch point: w ~ -1 + p - p^2/3 + 11 p^3/72,
    # p = sqrt(2(e z + 1))
    p = torch.sqrt(torch.clamp_min(2.0 * (math.e * zc + 1.0), 0.0))
    w_branch = -1.0 + p - p * p / 3.0 + 11.0 * (p * p * p) / 72.0
    # large z: asymptotic L1 - L2 + L2/L1
    lz = torch.log(torch.clamp_min(zc, 1e-300))
    llz = torch.log(torch.clamp_min(lz, 1e-300))
    w_big = lz - llz + llz / torch.clamp_min(lz, 1e-12)
    # moderate z: series around 0
    w_small = zc * (1.0 - zc + 1.5 * zc * zc)
    w = torch.where(zc < -0.25, w_branch,
                    torch.where(zc > 3.0, w_big, w_small))
    w = torch.clamp_min(w, -1.0 + 1e-12)

    for _ in range(iters):
        ew = torch.exp(w)
        f = w * ew - zc
        wp1 = w + 1.0
        denom = ew * wp1 - (w + 2.0) * f / (2.0 * wp1)
        step = f / torch.where(denom.abs() < 1e-300, 1e-300, denom)
        w = torch.clamp_min(w - step, -1.0 + 1e-15)
    return w
