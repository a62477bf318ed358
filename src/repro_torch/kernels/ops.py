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

Each Function's forward is one call of a `torch.library` custom op
(`repro_torch::flash_attention`, `::rwkv6_scan`, `::mamba_scan`) with
three implementations: the hand-written kernel for CUDA tensors, the
plain version for CPU tensors and, for "meta" tensors (an abstract pass:
`launch/dryrun.py`), a fake that gives only the output shapes and dtypes.
Each op has a FLOP formula (`flash_attention_flops`, `rwkv6_scan_flops`,
`mamba_scan_flops`: the operation counts of `chip_smoke.py`'s bounds),
which `torch.utils.flop_counter.FlopCounterMode` reads on any device.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from . import flash_attention as _flash
from . import mamba_scan as _mamba
from . import rwkv6_scan as _rwkv
from . import sp1_sweep, waterfill

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# operation counts (the FLOP formulas of the custom ops)
# ---------------------------------------------------------------------------

def kept_pairs(S: int, T: int, causal: bool, window: Optional[int]) -> int:
    """The (s, t) pairs `flash_attention`'s mask keeps: 0 <= s < S,
    0 <= t < T, t <= s when causal, s - t < window when a window is set.
    Summed over the diagonals d = s - t, each holding
    min(S, T + d) - max(0, d) pairs, piecewise linear in d."""
    lo = 0 if causal else -(T - 1)
    hi = S - 1 if window is None else min(S - 1, window - 1)
    if lo > hi:
        return 0

    def n(d):
        return min(S, T + d) - max(0, d)

    cuts = sorted({lo, hi + 1} | {c for c in (0, S - T) if lo < c <= hi})
    return sum((n(a) + n(b - 1)) * (b - a) // 2
               for a, b in zip(cuts, cuts[1:]))


def flash_attention_flops(B: int, H: int, S: int, T: int, hd: int, vd: int,
                          causal: bool, window: Optional[int]) -> int:
    """Each kept (s, t) pair of each (b, h) is an hd-long dot and a
    vd-long update, 2 operations a multiply-add (the exponentials left
    out)."""
    return B * H * kept_pairs(S, T, causal, window) * 2 * (hd + vd)


def rwkv6_scan_flops(B: int, T: int, H: int, K: int) -> int:
    """The recurrence's operations per (b, t, h): r S (2 K^2),
    S <- w S + k v^T (3 K^2), w = exp(log w) (K) and the u bonus (5 K)."""
    return B * T * H * (5 * K * K + 6 * K)


def mamba_scan_flops(B: int, T: int, D: int, N: int) -> int:
    """Per (b, t, d, n): the decay's product and exponential (2), the
    update a h + (dt B) x (4), the y term h C and its sum over n (2)."""
    return 8 * B * T * D * N


# ---------------------------------------------------------------------------
# the custom ops: kernel (CUDA), plain version (CPU), fake (meta)
# ---------------------------------------------------------------------------

# Declared with the low-level `torch.library.Library` API, each device's
# implementation registered under its dispatch key: a call goes from the
# dispatcher straight to the implementation (`torch.library.custom_op`'s
# wrapper imports torch._dynamo on a process's first call, seconds of
# host time, and adds ~40 us a call).
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int? window, float? scale) -> Tensor")
_LIB.define("rwkv6_scan(Tensor r, Tensor k, Tensor v, Tensor logw, "
            "Tensor u, int chunk) -> (Tensor, Tensor)")
_LIB.define("mamba_scan(Tensor dt, Tensor A, Tensor Bt, Tensor Ct, "
            "Tensor x) -> (Tensor, Tensor)")


def _flash_cuda(q, k, v, causal, window, scale):
    return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                  scale=scale)


def _flash_cpu(q, k, v, causal, window, scale):
    return _flash.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      scale=scale)


def _flash_fake(q, k, v, causal, window, scale):
    return q.new_empty((*q.shape[:3], v.shape[3]))


def _rwkv_cuda(r, k, v, logw, u, chunk):
    return _rwkv.rwkv6_scan(r, k, v, logw, u, chunk=chunk)


def _rwkv_cpu(r, k, v, logw, u, chunk):
    return _rwkv.rwkv6_scan_ref(r, k, v, logw, u, chunk=chunk)


def _rwkv_fake(r, k, v, logw, u, chunk):
    B, T, H, K = r.shape
    return (r.new_empty((B, T, H, K), dtype=torch.float32),
            r.new_empty((B, H, K, K), dtype=torch.float32))


def _mamba_cuda(dt, A, Bt, Ct, x):
    return _mamba.mamba_scan(dt, A, Bt, Ct, x)


def _mamba_cpu(dt, A, Bt, Ct, x):
    return _mamba.mamba_scan_ref(dt, A, Bt, Ct, x)


def _mamba_fake(dt, A, Bt, Ct, x):
    B, T, D = x.shape
    return (x.new_empty((B, T, D), dtype=torch.float32),
            x.new_empty((B, D, A.shape[1]), dtype=torch.float32))


for _name, _cuda, _cpu, _fake in (
        ("flash_attention", _flash_cuda, _flash_cpu, _flash_fake),
        ("rwkv6_scan", _rwkv_cuda, _rwkv_cpu, _rwkv_fake),
        ("mamba_scan", _mamba_cuda, _mamba_cpu, _mamba_fake)):
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")
    torch.library.register_fake(f"repro_torch::{_name}", _fake, lib=_LIB)

flash_attention_op = torch.ops.repro_torch.flash_attention.default
rwkv6_scan_op = torch.ops.repro_torch.rwkv6_scan.default
mamba_scan_op = torch.ops.repro_torch.mamba_scan.default


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q, k, v, causal, window, scale, *args, **kwargs):
    B, H, S, hd = q
    return flash_attention_flops(B, H, S, k[2], hd, v[3], causal, window)


@register_flop_formula(torch.ops.repro_torch.rwkv6_scan)
def _(r, k, v, logw, u, chunk, *args, **kwargs):
    return rwkv6_scan_flops(*r)


@register_flop_formula(torch.ops.repro_torch.mamba_scan)
def _(dt, A, Bt, Ct, x, *args, **kwargs):
    B, T, D = x
    return mamba_scan_flops(B, T, D, A[1])


# ---------------------------------------------------------------------------
# DTensor sharding rules (the dry run's partitioned pass, `launch/dryrun.py`)
# ---------------------------------------------------------------------------

@functools.cache
def register_sharding_rules() -> None:
    """Gives the three ops a DTensor sharding rule (once a process; the
    dry run calls it before its partitioned pass). Per mesh dimension each
    op runs replicated, split over the batch, or split over its heads (the
    Mamba scan: its inner channels), inputs and outputs alike, as the
    reference's `shard` sites lay out q / k / v ("batch", "seq", "heads",
    "head_dim") and the Mamba scan ("batch", "seq", "inner"); the per-head
    (per-channel) parameters u and A follow their heads (channels). An
    input placed otherwise (the sequence or head width split, a partial
    sum) is redistributed by DTensor to the cheapest of these, so no
    placement fails the pass. Splitting heads is exact only where q's and
    k's heads split alike: the models repeat K/V to q's heads under
    active rules (`models.attention._flash`), as the reference's
    `_chunked_attn` does."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    R = Replicate()

    @register_sharding(flash_attention_op)
    def _(q, k, v, causal, window, scale):
        rest = [None, None, None]
        return [([R], [R, R, R] + rest),
                ([Shard(0)], [Shard(0)] * 3 + rest),
                ([Shard(1)], [Shard(1)] * 3 + rest)]

    @register_sharding(rwkv6_scan_op)
    def _(r, k, v, logw, u, chunk):
        return [([R, R], [R] * 5 + [None]),
                ([Shard(0), Shard(0)], [Shard(0)] * 4 + [R, None]),
                ([Shard(2), Shard(1)], [Shard(2)] * 4 + [Shard(0), None])]

    @register_sharding(mamba_scan_op)
    def _(dt, A, Bt, Ct, x):
        return [([R, R], [R] * 5),
                ([Shard(0), Shard(0)], [Shard(0), R, Shard(0), Shard(0),
                                        Shard(0)]),
                ([Shard(2), Shard(1)], [Shard(2), Shard(0), R, R, Shard(2)])]


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
        return flash_attention_op(q, k, v, causal, window, scale)

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
        o, S = rwkv6_scan_op(r, k, v, logw, u, chunk)
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
        y, h = mamba_scan_op(dt, A, Bt, Ct, x)
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
