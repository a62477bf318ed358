"""Public entries of the port's kernels: the device picks the version.

Port of `repro/kernels/ops.py`. A CUDA tensor goes to the hand-written
kernel, and any failure there raises; a CPU tensor goes to the kernel's
plain PyTorch version. There is no switch and no fallback between them.

The three LM kernels are `torch.autograd.Function`s (`FlashAttention`,
`RWKV6Scan`, `MambaScan`), the same on both devices. Their forward is the
kernel or the plain version as above; their backward recomputes the op
from the saved inputs through a differentiable formulation the caller
passes as `backward` (the models pass the reference's own training
formulations: `models.attention._chunked_attn`, `models.ssm._wkv_chunked`
and `models.ssm._ssm_chunked`) and differentiates it with
`torch.autograd.grad`. There is no backward kernel, as the reference has
none. `backward=None` means forward only: every caller in the port's
models passes its formulation, and a backward without one raises. The scans' final states are
not differentiable: they feed the decode cache, never a loss.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from . import flash_attention as _flash
from . import mamba_scan as _mamba
from . import rwkv6_scan as _rwkv
from . import sp1_sweep, waterfill

Tensor = torch.Tensor


def _device(name: str, x: Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return x.device.type


def _recomputed_grads(name: str, formulation: Optional[Callable],
                      inputs: Sequence[Tensor], needs: Sequence[bool],
                      grad_out: Tensor, **kw) -> Tuple[Optional[Tensor], ...]:
    """The gradients of formulation(*inputs, **kw)'s first output, against
    `grad_out`, for each input that `needs` one (None for the others)."""
    if formulation is None:
        raise RuntimeError(f"{name}: a gradient was asked for, but no "
                           "backward formulation was given")
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = formulation(*xs, **kw)
        out = out[0] if isinstance(out, tuple) else out
        wrt = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(out, wrt, grad_out,
                                       allow_unused=True,
                                       materialize_grads=True))
    return tuple(next(got) if n else None for n in needs)


class FlashAttention(torch.autograd.Function):
    """`flash_attention` with a gradient: q, k, v in, o out."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, backward):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(causal=causal, window=window, scale=scale)
        ctx.formulation = backward
        if _device("flash_attention", q) == "cuda":
            return _flash.flash_attention(q, k, v, causal=causal,
                                          window=window, scale=scale)
        return _flash.flash_attention_ref(q, k, v, causal=causal,
                                          window=window, scale=scale)

    @staticmethod
    def backward(ctx, go):
        grads = _recomputed_grads("flash_attention", ctx.formulation,
                                  ctx.saved_tensors, ctx.needs_input_grad[:3],
                                  go, **ctx.args)
        return (*grads, None, None, None, None)


def _no_state_grad(name: str, g_state: Optional[Tensor]):
    if g_state is not None:
        raise RuntimeError(f"{name}: the final state has no gradient")


class RWKV6Scan(torch.autograd.Function):
    """`rwkv6_scan` with a gradient: r, k, v, logw, u in; o out (S_end is
    not differentiable)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, chunk, backward):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, logw, u)
        ctx.chunk, ctx.formulation = chunk, backward
        if _device("rwkv6_scan", r) == "cuda":
            o, S = _rwkv.rwkv6_scan(r, k, v, logw, u, chunk=chunk)
        else:
            o, S = _rwkv.rwkv6_scan_ref(r, k, v, logw, u, chunk=chunk)
        ctx.mark_non_differentiable(S)
        return o, S

    @staticmethod
    def backward(ctx, go, g_state):
        _no_state_grad("rwkv6_scan", g_state)
        grads = _recomputed_grads("rwkv6_scan", ctx.formulation,
                                  ctx.saved_tensors, ctx.needs_input_grad[:5],
                                  go, chunk=ctx.chunk)
        return (*grads, None, None)


class MambaScan(torch.autograd.Function):
    """`mamba_scan` with a gradient: dt, A, Bt, Ct, x in; y out (h_end is
    not differentiable)."""

    @staticmethod
    def forward(ctx, dt, A, Bt, Ct, x, backward):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dt, A, Bt, Ct, x)
        ctx.formulation = backward
        if _device("mamba_scan", x) == "cuda":
            y, h = _mamba.mamba_scan(dt, A, Bt, Ct, x)
        else:
            y, h = _mamba.mamba_scan_ref(dt, A, Bt, Ct, x)
        ctx.mark_non_differentiable(h)
        return y, h

    @staticmethod
    def backward(ctx, gy, g_state):
        _no_state_grad("mamba_scan", g_state)
        grads = _recomputed_grads("mamba_scan", ctx.formulation,
                                  ctx.saved_tensors, ctx.needs_input_grad[:5],
                                  gy)
        return (*grads, None)


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
                    scale: Optional[float] = None,
                    backward: Optional[Callable] = None) -> Tensor:
    """GQA attention (used by `models.attention`): q (B, H, S, hd),
    k (B, KV, T, hd), v (B, KV, T, vd) -> (B, H, S, vd), in q's dtype.
    `backward(q, k, v, causal=, window=, scale=)` is the differentiable
    formulation its gradient is taken through."""
    return FlashAttention.apply(q, k, v, causal, window, scale, backward)


def rwkv6_scan(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor, *,
               chunk: int = 64, backward: Optional[Callable] = None
               ) -> Tuple[Tensor, Tensor]:
    """Chunked WKV6 from a zero state (used by `models.ssm`):
    r, k, v, logw (B, T, H, K), u (H, K) -> (o (B, T, H, K),
    S_end (B, H, K, K)), float32. `backward(r, k, v, logw, u, chunk=)` is
    the differentiable formulation o's gradient is taken through."""
    return RWKV6Scan.apply(r, k, v, logw, u, chunk, backward)


def mamba_scan(dt: Tensor, A: Tensor, Bt: Tensor, Ct: Tensor, x: Tensor, *,
               backward: Optional[Callable] = None) -> Tuple[Tensor, Tensor]:
    """Selective scan from a zero state (used by `models.ssm`'s Mamba):
    dt, x (B, T, D), A (D, N), Bt, Ct (B, T, N) -> (y (B, T, D),
    h_end (B, D, N)), float32. `backward(dt, A, Bt, Ct, x)` is the
    differentiable formulation y's gradient is taken through."""
    return MambaScan.apply(dt, A, Bt, Ct, x, backward)


def launch_counts() -> dict:
    """Launches of every kernel so far, by name."""
    return {"sp1_lambda_sum": sp1_sweep.sp1_lambda_sum.launches,
            "waterfill_gprime": waterfill.waterfill_gprime.launches,
            "flash_attention": _flash.flash_attention.launches,
            "rwkv6_scan": _rwkv.rwkv6_scan.launches,
            "mamba_scan": _mamba.mamba_scan.launches}
