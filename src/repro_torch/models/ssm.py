"""RWKV6 "Finch": WKV with data-dependent decay.

Port of the RWKV6 parts of `repro/models/ssm.py`. The prefill's chunked
WKV scan goes through `kernels.ops.rwkv6_scan` (the CUDA kernel on the card,
its plain chunked version on the CPU), which also returns the final state
for the decode cache; decode is the single-step recurrence in plain torch.
Decays live in log space, and every in-chunk decay factor is
exp(clw'_t - clw_tau) <= 1. r, k, v and the decay are float32 in every mode,
the WKV state is float32, and the token-shift states `x_tm` / `x_cm` are
bfloat16 whatever the model's dtype, as in the reference. Mamba is not
ported (ROADMAP.md, Queue 2 item 5).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..kernels import ops as kops
from .layers import const, normal

Tensor = torch.Tensor


class RWKVCache(NamedTuple):
    state: Tensor     # (B, H, K, V) wkv state, float32
    x_tm: Tensor      # (B, D) previous token (time-mix shift), bfloat16
    x_cm: Tensor      # (B, D) previous token (channel-mix shift), bfloat16


def mamba(*args, **kwargs):
    raise NotImplementedError("mamba layers are not ported yet (ROADMAP.md, "
                              "Queue 2 item 5: mamba_scan)")


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
        o, S1 = kops.rwkv6_scan(r, k, v, logw, p["u"].float(), chunk=chunk)
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
