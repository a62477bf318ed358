"""Attention: MHA / GQA / MQA (+ QKV bias) and sliding windows, with full or
ring-buffer KV caches for decode.

Port of the GQA self-attention parts of `repro/models/attention.py`.
Conventions as there: x (B, S, D), H query heads, KV key/value heads
(H % KV == 0), head_dim hd; RoPE is applied before caching, so a ring
buffer stays valid whatever its slot order; softmax in float32.

Prefill attention goes through `kernels.ops.flash_attention` (the CUDA
kernel on the card, its plain version on the CPU), where the reference
runs its XLA path `_chunked_attn`. Decode (one token per call) is the
plain `_grouped_attn`, as in the reference. The caches are updated in
place. MLA, cross-attention and the int8 cache are not ported
(ROADMAP.md, Queue 1 item 12) and raise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from ..kernels import ops as kops
from .layers import apply_rope, normal

Tensor = torch.Tensor

NEG_INF = -1e30
_NOT_PORTED = "not ported yet (ROADMAP.md, Queue 1 item 12)"


class KVCache(NamedTuple):
    k: Tensor           # (B, S_slots, KV, hd)   roped keys
    v: Tensor           # (B, S_slots, KV, hd)


class Attention(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, n_heads: int,
                 kv_heads: int, head_dim: int, qkv_bias: bool,
                 dtype: torch.dtype):
        super().__init__()
        sd = (2.0 / (d_model + n_heads * head_dim)) ** 0.5
        self.wq = normal(gen, (d_model, n_heads, head_dim), sd, dtype)
        self.wk = normal(gen, (d_model, kv_heads, head_dim), sd, dtype)
        self.wv = normal(gen, (d_model, kv_heads, head_dim), sd, dtype)
        self.wo = normal(gen, (n_heads, head_dim, d_model), sd, dtype)
        if qkv_bias:
            for name, h in (("bq", n_heads), ("bk", kv_heads),
                            ("bv", kv_heads)):
                setattr(self, name, nn.Parameter(torch.zeros(
                    (h, head_dim), dtype=dtype, device=gen.device),
                    requires_grad=False))
        else:
            self.bq = self.bk = self.bv = None


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   kv_heads: int, head_dim: int, qkv_bias: bool = False,
                   dtype: torch.dtype = torch.bfloat16) -> Attention:
    return Attention(gen, d_model, n_heads, kv_heads, head_dim, qkv_bias,
                     dtype)


def init_kv_cache(batch: int, slots: int, kv_heads: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16, quantized: bool = False,
                  device=None) -> KVCache:
    if quantized:
        raise NotImplementedError(f"int8 KV cache: {_NOT_PORTED}")
    shp = (batch, slots, kv_heads, head_dim)
    return KVCache(k=torch.zeros(shp, dtype=dtype, device=device),
                   v=torch.zeros(shp, dtype=dtype, device=device))


def _fill_cache(cache: KVCache, k: Tensor, v: Tensor) -> KVCache:
    """Block prefill: write the S roped K/V positions 0..S-1 into the cache,
    in place. A ring cache keeps the last `slots` positions at slot
    pos % slots."""
    slots = cache.k.shape[1]
    S = k.shape[1]
    first = max(S - slots, 0)
    slot_idx = torch.arange(first, S, device=k.device) % slots
    cache.k[:, slot_idx] = k[:, first:].to(cache.k.dtype)
    cache.v[:, slot_idx] = v[:, first:].to(cache.v.dtype)
    return cache


def _project(x: Tensor, w: Tensor) -> Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    D, H, K = w.shape
    return torch.matmul(x, w.reshape(D, H * K)).unflatten(-1, (H, K))


def _out(o: Tensor, wo: Tensor) -> Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    H, K, D = wo.shape
    return torch.matmul(o.reshape(*o.shape[:2], H * K), wo.reshape(H * K, D))


def _grouped_attn(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor],
                  scale: float) -> Tensor:
    """q (B,S,H,hd), k/v (B,T,KV,*) -> (B,S,H,vd); mask (.., S, T) boolean
    (True = attend) broadcast over (B, KV, G) or None. The decode path."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, S, KV, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float() * scale
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H, out.shape[-1])


def _causal_mask(S: int, T: int, q_offset: int = 0,
                 window: Optional[int] = None, device=None) -> Tensor:
    """(1, 1, S, T) boolean: True = attend. Query i sits at q_offset + i."""
    qpos = torch.arange(S, device=device) + q_offset
    kpos = torch.arange(T, device=device)
    ok = kpos[None, :] <= qpos[:, None]
    if window is not None:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    return ok[None, None]


def attention(p: Attention, x: Tensor, *, positions: Optional[Tensor] = None,
              mode: str = "train", cache: Optional[KVCache] = None,
              pos: Union[int, Tensor, None] = None,
              window: Optional[int] = None, causal: bool = True,
              rope_theta: float = 10000.0, kv_x: Optional[Tensor] = None,
              cross_kv=None, use_rope: bool = True
              ) -> Tuple[Tensor, Optional[KVCache]]:
    """Returns (out (B, S, D), new_cache).

    mode "train" / "prefill": full-sequence self-attention (the flash
        kernel); "prefill" also fills `cache` when one is given.
    mode "decode": S == 1; writes `cache` at absolute position `pos`
        (ring-buffered when `window` is set) and attends over it.
    """
    if kv_x is not None or cross_kv is not None:
        raise NotImplementedError(f"cross-attention: {_NOT_PORTED}")
    B, S, D = x.shape
    hd = p.wq.shape[2]
    scale = hd ** -0.5

    q = _project(x, p.wq)
    k = _project(x, p.wk)
    v = _project(x, p.wv)
    if p.bq is not None:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv

    if mode in ("train", "prefill"):
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        if use_rope:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
        out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window if causal else None,
                                   scale=scale)
        new_cache = None
        if mode == "prefill" and cache is not None:
            new_cache = _fill_cache(cache, k, v)
        return _out(out.transpose(1, 2), p.wo), new_cache

    # ---- decode -----------------------------------------------------------
    if S != 1 or cache is None or pos is None:
        raise ValueError("attention: decode takes one token, a cache and pos")
    pos = int(pos)
    if use_rope:
        pv = torch.full((B, 1), pos, device=x.device)
        q = apply_rope(q, pv, rope_theta)
        k = apply_rope(k, pv, rope_theta)
    slots = cache.k.shape[1]
    slot = pos % slots if window is not None else pos
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    kpos = torch.arange(slots, device=x.device)
    if window is not None:
        valid = (kpos <= pos % slots) | (pos >= slots)
    else:
        valid = kpos <= pos
    out = _grouped_attn(q, cache.k, cache.v, valid[None, None, None, None, :],
                        scale)
    return _out(out, p.wo), cache
