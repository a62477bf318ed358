"""State-space / linear-recurrence mixers: Mamba (selective scan, for Jamba)
and RWKV6 "Finch" (WKV with data-dependent decay).

Port of `repro/models/ssm.py`. Train and prefill go through a kernel that
also returns the final state for the decode cache: Mamba's selective scan
through `kernels.ops.mamba_scan`, RWKV6's chunked WKV through
`kernels.ops.rwkv6_scan` (the CUDA kernels on the card, their plain
versions on the CPU). Their gradients are taken through the reference's
training formulations, ported here: `_ssm_chunked` (the in-chunk
associative scan of `_ssm_chunk`, chunk `ssm_chunk`, its state-free terms
for all whole chunks at once) and `_wkv_chunked`
(`_wkv_chunk` per chunk of `rwkv_chunk`, its state-independent terms
for several chunks at once). Decode is the single-step recurrence in plain
torch.

Mamba: the reference scans chunk by chunk, carrying the causal conv's tail
and the state; the port computes the causal depthwise conv over the whole
sequence in one pass (the same taps in the same order) and makes one scan
call over the whole sequence, so any prompt length hands its state over to
decode. dt, B, C, the state and the scan are float32; the conv tail is
cached in the model dtype, as in the reference.

RWKV6: decays live in log space, and every in-chunk decay factor is
exp(clw'_t - clw_tau) <= 1. r, k, v and the decay are float32 in every mode,
the WKV state is float32, and the token-shift states `x_tm` / `x_cm` are
bfloat16 whatever the model's dtype, as in the reference.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import ops as kops
from ..sharding.partition import shard
from .layers import const, normal

Tensor = torch.Tensor


# ===========================================================================
# Mamba (selective SSM)
# ===========================================================================

class MambaCache(NamedTuple):
    conv: Tensor      # (B, K_conv - 1, Di) last inputs of the causal conv
    h: Tensor         # (B, Di, N) recurrent state, float32


class Mamba(nn.Module):
    """One Mamba mixer, named as the reference's `init_mamba` leaves, with
    its distributions and scales."""

    def __init__(self, gen: torch.Generator, d_model: int, d_inner: int,
                 d_state: int = 16, d_conv: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        dt_rank = max(d_model // 16, 1)
        sd = (1.0 / d_model) ** 0.5
        dev = gen.device
        self.in_proj = normal(gen, (d_model, d_inner), sd, dtype)
        self.gate_proj = normal(gen, (d_model, d_inner), sd, dtype)
        self.conv_w = normal(gen, (d_conv, d_inner), 0.2, dtype)
        self.conv_b = const((d_inner,), 0.0, dev, dtype)
        self.a_log = nn.Parameter(torch.log(torch.arange(
            1, d_state + 1, dtype=torch.float32, device=dev).expand(
            d_inner, d_state).contiguous()), requires_grad=False)
        self.d = const((d_inner,), 1.0, dev)
        self.dt_w = normal(gen, (d_inner, dt_rank), sd, dtype)
        self.dt_proj = normal(gen, (dt_rank, d_inner), dt_rank ** -0.5, dtype)
        # softplus^-1(0.01), rounded once from float64
        self.dt_bias = const((d_inner,), math.log(math.expm1(0.01)), dev)
        self.bc_proj = normal(gen, (d_inner, 2 * d_state), sd, dtype)
        self.out_proj = normal(gen, (d_inner, d_model),
                               (1.0 / d_inner) ** 0.5, dtype)


def init_mamba_cache(batch: int, d_inner: int, d_state: int = 16,
                     d_conv: int = 4, dtype: torch.dtype = torch.bfloat16,
                     device=None) -> MambaCache:
    return MambaCache(
        conv=torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                         device=device),
        h=torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                      device=device))


def _dt_bc(p: Mamba, xc: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """dt = softplus(xc dt_w dt_proj + dt_bias) and B, C = split(xc bc_proj),
    float32; B and C are views of one (..., 2N) tensor."""
    dt = torch.nn.functional.softplus(
        torch.matmul(torch.matmul(xc, p.dt_w), p.dt_proj) + p.dt_bias).float()
    Bt, Ct = torch.matmul(xc, p.bc_proj).float().chunk(2, dim=-1)
    return dt, Bt, Ct


def _assoc_scan(la: Tensor, u: Tensor) -> Tensor:
    """Inclusive scan over axis 1 of the reference's `comb`, (a1, b1) then
    (a2, b2) -> (a1 + a2, exp(a2) b1 + b2), in log2(L) doubling steps
    (Hillis-Steele; the reference's `jax.lax.associative_scan` is another
    log-depth order of the same combine). Returns the b part."""
    a, b = la, u
    d, L = 1, la.shape[1]
    while d < L:
        b = torch.cat([b[:, :d], torch.exp(a[:, d:]) * b[:, :-d] + b[:, d:]],
                      dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] + a[:, d:]], dim=1)
        d *= 2
    return b


def _ssm_chunk(h0: Tensor, dt: Tensor, A: Tensor, Bt: Tensor, Ct: Tensor,
               x: Tensor) -> Tuple[Tensor, Tensor]:
    """The reference's in-chunk parallel selective scan (`_ssm_chunk`): h0
    (B,Di,N); dt, x (B,L,Di); A (Di,N); Bt, Ct (B,L,N) -> (y (B,L,Di),
    h_L). Every decay factor is exp of a sum of dt A <= 0."""
    la = dt[..., None] * A                                  # (B,L,Di,N)
    u = dt[..., None] * Bt[:, :, None, :] * x[..., None]
    h = torch.exp(torch.cumsum(la, dim=1)) * h0[:, None] + _assoc_scan(la, u)
    return torch.einsum("bldn,bln->bld", h, Ct), h[:, -1]


def _ssm_chunked(dt: Tensor, A: Tensor, Bt: Tensor, Ct: Tensor, x: Tensor,
                 *, chunk: int) -> Tuple[Tensor, Tensor]:
    """`_ssm_chunk` over the sequence in chunks of `chunk` (the last may be
    short), the state carried from a zero one: the Mamba scan's training
    formulation, which `mamba_scan`'s gradient is taken through. Same
    signature and result as `kernels.ops.mamba_scan`.

    The whole chunks' state-free terms (each chunk's decays
    exp(cumsum(dt A)) and its scan from a zero state) are formed for all
    chunks at once, chunks folded into the batch; only the state is
    carried chunk to chunk (h <- decay_end h + scan_end), then added in:
    `_ssm_chunk`'s operations on the same operands, in far fewer calls."""
    B, T, D = x.shape
    h = torch.zeros((B, D, A.shape[1]), dtype=torch.float32, device=x.device)
    n = T // chunk
    ys = []
    if n:
        def fold(t):
            return t[:, :n * chunk].reshape(B * n, chunk, *t.shape[2:])

        dtc, Bc, Cc, xc = (fold(t) for t in (dt, Bt, Ct, x))
        la = dtc[..., None] * A                             # (Bn,L,Di,N)
        u = dtc[..., None] * Bc[:, :, None, :] * xc[..., None]
        decay = torch.exp(torch.cumsum(la, dim=1)).unflatten(0, (B, n))
        scan = _assoc_scan(la, u).unflatten(0, (B, n))
        h_in = []
        for c in range(n):
            h_in.append(h)
            h = decay[:, c, -1] * h + scan[:, c, -1]
        hs = decay * torch.stack(h_in, 1)[:, :, None] + scan
        ys.append(torch.einsum("bcldn,bcln->bcld", hs,
                               Cc.unflatten(0, (B, n))).reshape(B, n * chunk,
                                                                D))
    if T > n * chunk:
        c0 = n * chunk
        y, h = _ssm_chunk(h, dt[:, c0:], A, Bt[:, c0:], Ct[:, c0:],
                          x[:, c0:])
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba(p: Mamba, x: Tensor, *, mode: str = "train",
          cache: Optional[MambaCache] = None, chunk: int = 256
          ) -> Tuple[Tensor, Optional[MambaCache]]:
    """x (B, S, D) -> (out (B, S, D), cache'). "decode" takes S == 1 and a
    cache; "prefill" with a cache returns the filled one (any S); "train"
    returns None. `chunk` is the training formulation's (`_ssm_chunked`)."""
    B, S, D = x.shape
    A = -torch.exp(p.a_log)                                 # (Di, N)
    Kc = p.conv_w.shape[0]
    silu = torch.nn.functional.silu
    xin = shard(torch.matmul(x, p.in_proj), "batch", "seq", "inner")
    z = torch.matmul(x, p.gate_proj)

    if mode == "decode":
        if S != 1 or cache is None:
            raise ValueError("mamba: decode takes one token and a cache")
        conv_in = torch.cat([cache.conv, xin], dim=1)       # (B, K, Di)
        xc = torch.einsum("bke,ke->be", conv_in[:, -Kc:], p.conv_w) \
            + p.conv_b
        xc = silu(xc)
        dt, Bt, Ct = _dt_bc(p, xc)                          # (B,Di), (B,N)
        xf = xc.float()
        h = torch.exp(dt[..., None] * A) * cache.h \
            + dt[..., None] * Bt[:, None, :] * xf[..., None]
        y = torch.einsum("bdn,bn->bd", h, Ct) + p.d * xf
        out = (y.to(x.dtype) * silu(z[:, 0]))[:, None]
        return torch.matmul(out, p.out_proj), MambaCache(conv=conv_in[:, 1:],
                                                        h=h)

    # train / prefill: the causal depthwise conv over the whole sequence,
    # taps summed in the reference's order, then one scan
    xext = torch.cat([torch.zeros((B, Kc - 1, xin.shape[-1]), dtype=xin.dtype,
                                  device=xin.device), xin], dim=1)
    xconv = xext[:, :S] * p.conv_w[0]
    for i in range(1, Kc):
        xconv = xconv + xext[:, i:i + S] * p.conv_w[i]
    xconv = silu(xconv + p.conv_b)
    dt, Bt, Ct = _dt_bc(p, xconv)
    xf = xconv.float()
    y, h_end = kops.mamba_scan(
        dt, A, Bt, Ct, xf,
        backward=functools.partial(_ssm_chunked, chunk=chunk))
    y = (y + p.d * xf).to(x.dtype)
    out = torch.matmul(y * silu(z), p.out_proj)
    new_cache = None
    if mode == "prefill" and cache is not None:
        # a copy, so the cache does not hold the whole padded sequence
        new_cache = MambaCache(
            conv=xext[:, xext.shape[1] - (Kc - 1):].clone(), h=h_end)
    return out, new_cache


# ===========================================================================
# RWKV6 (Finch): WKV with data-dependent decay
# ===========================================================================

class RWKVCache(NamedTuple):
    state: Tensor     # (B, H, K, V) wkv state, float32
    x_tm: Tensor      # (B, D) previous token (time-mix shift), bfloat16
    x_cm: Tensor      # (B, D) previous token (channel-mix shift), bfloat16


def _time_mix_params(m: nn.Module, gen: torch.Generator, d_model: int,
                     n_heads: int, head_dim: int, lora_rank: int,
                     dtype: torch.dtype, prefix: str):
    sd = (1.0 / d_model) ** 0.5
    H, K = n_heads, head_dim
    dev = gen.device
    p = dict(
        r_proj=normal(gen, (d_model, H, K), sd, dtype),
        k_proj=normal(gen, (d_model, H, K), sd, dtype),
        v_proj=normal(gen, (d_model, H, K), sd, dtype),
        g_proj=normal(gen, (d_model, H, K), sd, dtype),
        # decay = exp(-exp(w0 + x @ lora_a @ lora_b))  (data-dependent)
        w_lora_a=normal(gen, (d_model, lora_rank), sd, dtype),
        w_lora_b=normal(gen, (lora_rank, H, K), 0.01, dtype),
        w0=const((H, K), -0.6, dev),
        u=normal(gen, (H, K), 0.1, torch.float32),
        o_proj=normal(gen, (H, K, d_model), sd, dtype),
        mix_r=const((d_model,), 0.5, dev),
        mix_k=const((d_model,), 0.5, dev),
        mix_v=const((d_model,), 0.5, dev),
        mix_w=const((d_model,), 0.5, dev),
        mix_g=const((d_model,), 0.5, dev),
    )
    for k, v in p.items():
        setattr(m, prefix + k, v)


def _channel_mix_params(m: nn.Module, gen: torch.Generator, d_model: int,
                        d_ff: int, dtype: torch.dtype, prefix: str):
    sd = (1.0 / d_model) ** 0.5
    dev = gen.device
    p = dict(
        ffn_k=normal(gen, (d_model, d_ff), sd, dtype),
        ffn_v=normal(gen, (d_ff, d_model), (1.0 / d_ff) ** 0.5, dtype),
        ffn_r=normal(gen, (d_model, d_model), sd, dtype),
        mix_k=const((d_model,), 0.5, dev),
        mix_r=const((d_model,), 0.5, dev),
    )
    for k, v in p.items():
        setattr(m, prefix + k, v)


class RWKV(nn.Module):
    """One rwkv block's time mix (`tm_*`) and channel mix (`cm_*`), named
    as the reference's `init_rwkv` leaves."""

    def __init__(self, gen: torch.Generator, d_model: int, n_heads: int,
                 head_dim: int, d_ff: int, dtype: torch.dtype,
                 lora_rank: int = 64):
        super().__init__()
        _time_mix_params(self, gen, d_model, n_heads, head_dim, lora_rank,
                         dtype, "tm_")
        _channel_mix_params(self, gen, d_model, d_ff, dtype, "cm_")

    def part(self, prefix: str) -> dict:
        """The time-mix ("tm_") or channel-mix ("cm_") leaves, unprefixed."""
        return {k[len(prefix):]: v for k, v in self.named_parameters()
                if k.startswith(prefix)}


def init_rwkv_cache(batch: int, d_model: int, n_heads: int, head_dim: int,
                    device=None) -> RWKVCache:
    return RWKVCache(
        state=torch.zeros((batch, n_heads, head_dim, head_dim),
                          dtype=torch.float32, device=device),
        x_tm=torch.zeros((batch, d_model), dtype=torch.bfloat16,
                         device=device),
        x_cm=torch.zeros((batch, d_model), dtype=torch.bfloat16,
                         device=device))


def _shift(x: Tensor, x_prev: Tensor) -> Tensor:
    """Token shift: prepend x_prev, drop the last. x (B,S,D), x_prev (B,D)."""
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _mix(x: Tensor, xs: Tensor, mu: Tensor) -> Tensor:
    return x + (xs - x) * mu


def _proj(x: Tensor, w: Tensor) -> Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    D, H, K = w.shape
    return torch.matmul(x, w.reshape(D, H * K)).unflatten(-1, (H, K))


def _wkv_intra(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The state-independent terms of the reference's `_wkv_chunk` for a
    stack of chunks: r, k, v, logw (B, n, L, H, K), u (H, K) -> (the
    in-chunk pairs' and the u bonus's output (B, n, L, H, K), each chunk's
    r exp(clw') (B, n, L, H, K), its own state increment
    sum_tau exp(clw_L - clw_tau) k_tau v_tau^T (B, n, H, K, K) and its
    decay exp(clw_L) (B, n, H, K)), every in-chunk decay factor
    exp(clw'_t - clw_tau) <= 1."""
    Lc = r.shape[2]
    clw = torch.cumsum(logw, dim=2)                         # inclusive
    clw_prev = clw - logw                                   # exclusive
    decay = clw_prev[:, :, :, None] - clw[:, :, None]       # (B,n,t,tau,H,K)
    idx = torch.arange(Lc, device=r.device)
    mask = (idx[:, None] > idx[None, :])[None, None, :, :, None, None]
    fac = torch.exp(torch.where(mask, decay,
                                torch.full((), -torch.inf, device=r.device)))
    att = torch.einsum("bnlhk,bnlthk,bnthk->bnlth", r, fac, k)
    o = torch.einsum("bnlth,bnthv->bnlhv", att, v)
    o = o + torch.einsum("bnlhk,bnlhk,bnlhv->bnlhv", r, u * k, v)
    inc = torch.einsum("bnlhk,bnlhv->bnhkv",
                       torch.exp(clw[:, :, -1:] - clw) * k, v)
    return o, r * torch.exp(clw_prev), inc, torch.exp(clw[:, :, -1])


def _wkv_chunked(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
                 *, chunk: int, group: int = 8) -> Tuple[Tensor, Tensor]:
    """RWKV6's training formulation, which `rwkv6_scan`'s gradient is taken
    through: the reference's `_wkv_chunk` over the sequence in chunks of
    `chunk` from a zero state, the tail padded with r = k = v = 0, log w
    = 0 (as the reference pads). Per chunk, o = r exp(clw') . S0 + the
    in-chunk pairs + the u bonus, and S_L = exp(clw_L) S0 + the chunk's
    increment. Everything but the (K, V) state is independent of S0, so
    `_wkv_intra` forms it for `group` chunks at once (checkpointed: a
    backward holds one group's (B, group, L, L, H, K) decays at a time)
    and only the state is carried chunk to chunk. Same signature and
    result as `kernels.ops.rwkv6_scan`."""
    B, T, H, K = r.shape
    pad = (-T) % chunk
    n = (T + pad) // chunk
    r, k, v, logw = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                     .reshape(B, n, chunk, H, K) for t in (r, k, v, logw))
    parts = [checkpoint(_wkv_intra, *(t[:, g0:g0 + group]
                                      for t in (r, k, v, logw)), u,
                        use_reentrant=False) for g0 in range(0, n, group)]
    o_in, r_dec, inc, w_end = (torch.cat(x, dim=1) for x in zip(*parts))
    S = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    outs = []
    for c in range(n):
        outs.append(torch.einsum("blhk,bhkv->blhv", r_dec[:, c], S))
        S = w_end[:, c][..., None] * S + inc[:, c]
    o = o_in + torch.stack(outs, dim=1)
    return o.reshape(B, n * chunk, H, K)[:, :T], S


def rwkv_time_mix(p: dict, x: Tensor, *, n_heads: int, head_dim: int,
                  mode: str = "train", cache: Optional[RWKVCache] = None,
                  chunk: int = 64) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (out (B,S,D), new_state (B,H,K,K), new x_prev (B,D))."""
    B, S, D = x.shape
    H, K = n_heads, head_dim
    decode = mode == "decode"
    if decode:
        if S != 1 or cache is None:
            raise ValueError("rwkv_time_mix: decode takes one token and a "
                             "cache")
        xs = cache.x_tm[:, None]
    else:
        xs = _shift(x, torch.zeros((B, D), dtype=x.dtype, device=x.device))

    xr, xk, xv, xw, xg = (_mix(x, xs, p[f"mix_{c}"]).to(x.dtype)
                          for c in "rkvwg")
    r = _proj(xr, p["r_proj"]).float()
    k = _proj(xk, p["k_proj"]).float()
    v = _proj(xv, p["v_proj"]).float()
    g = _proj(xg, p["g_proj"])
    lora = torch.matmul(xw, p["w_lora_a"])
    ww = p["w0"] + _proj(lora, p["w_lora_b"]).float()
    logw = -torch.exp(ww)                                   # log decay < 0

    if decode:
        S0 = cache.state
        o = torch.einsum("bhk,bhkv->bhv", r[:, 0], S0) \
            + torch.einsum("bhk,bhv->bhv", r[:, 0] * p["u"][None] * k[:, 0],
                           v[:, 0])
        S1 = torch.exp(logw[:, 0])[..., None] * S0 \
            + torch.einsum("bhk,bhv->bhkv", k[:, 0], v[:, 0])
        o = o[:, None]
    else:
        o, S1 = kops.rwkv6_scan(r, k, v, logw, p["u"].float(), chunk=chunk,
                                backward=_wkv_chunked)
    out = (o * torch.nn.functional.silu(g).float()).to(x.dtype)
    H_, K_, Dm = p["o_proj"].shape
    out = torch.matmul(out.reshape(B, S, H_ * K_), p["o_proj"].reshape(
        H_ * K_, Dm))
    return out, S1, x[:, -1]


def rwkv_channel_mix(p: dict, x: Tensor, *, mode: str = "train",
                     x_prev: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Tensor]:
    B, S, D = x.shape
    if mode == "decode" and x_prev is not None:
        xs = x_prev[:, None]
    else:
        xs = _shift(x, torch.zeros((B, D), dtype=x.dtype, device=x.device))
    xk = _mix(x, xs, p["mix_k"]).to(x.dtype)
    xr = _mix(x, xs, p["mix_r"]).to(x.dtype)
    kk = torch.square(torch.relu(torch.matmul(xk, p["ffn_k"])))
    vv = torch.matmul(kk, p["ffn_v"])
    rr = torch.sigmoid(torch.matmul(xr, p["ffn_r"]))
    return rr * vv, x[:, -1]
