"""Public entries of the port's kernels: the device picks the version.

Port of `repro/kernels/ops.py`. A CUDA tensor goes to the hand-written
kernel, and any failure there raises; a CPU tensor goes to the kernel's
plain PyTorch version. There is no switch and no fallback between them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import flash_attention as _flash
from . import mamba_scan as _mamba
from . import rwkv6_scan as _rwkv
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


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> Tensor:
    """GQA attention (used by `models.attention`'s prefill): q (B, H, S, hd),
    k (B, KV, T, hd), v (B, KV, T, vd) -> (B, H, S, vd), in q's dtype."""
    if q.device.type == "cuda":
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      scale=scale)
    if q.device.type == "cpu":
        return _flash.flash_attention_ref(q, k, v, causal=causal,
                                          window=window, scale=scale)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def rwkv6_scan(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor, *,
               chunk: int = 64) -> Tuple[Tensor, Tensor]:
    """Chunked WKV6 from a zero state (used by `models.ssm`'s prefill):
    r, k, v, logw (B, T, H, K), u (H, K) -> (o (B, T, H, K),
    S_end (B, H, K, K)), float32."""
    if r.device.type == "cuda":
        return _rwkv.rwkv6_scan(r, k, v, logw, u, chunk=chunk)
    if r.device.type == "cpu":
        return _rwkv.rwkv6_scan_ref(r, k, v, logw, u, chunk=chunk)
    raise ValueError(f"rwkv6_scan: no kernel for device {r.device}")


def mamba_scan(dt: Tensor, A: Tensor, Bt: Tensor, Ct: Tensor,
               x: Tensor) -> Tuple[Tensor, Tensor]:
    """Selective scan from a zero state (used by `models.ssm`'s Mamba
    prefill): dt, x (B, T, D), A (D, N), Bt, Ct (B, T, N) -> (y (B, T, D),
    h_end (B, D, N)), float32."""
    if x.device.type == "cuda":
        return _mamba.mamba_scan(dt, A, Bt, Ct, x)
    if x.device.type == "cpu":
        return _mamba.mamba_scan_ref(dt, A, Bt, Ct, x)
    raise ValueError(f"mamba_scan: no kernel for device {x.device}")


def launch_counts() -> dict:
    """Launches of every kernel so far, by name."""
    return {"sp1_lambda_sum": sp1_sweep.sp1_lambda_sum.launches,
            "waterfill_gprime": waterfill.waterfill_gprime.launches,
            "flash_attention": _flash.flash_attention.launches,
            "rwkv6_scan": _rwkv.rwkv6_scan.launches,
            "mamba_scan": _mamba.mamba_scan.launches}
