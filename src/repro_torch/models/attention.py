"""Attention: MHA / GQA / MQA (+ QKV bias), sliding windows, MLA and
cross-attention, with full, ring-buffer or int8 KV caches for decode.

Port of `repro/models/attention.py`. Conventions as there: x (B, S, D), H
query heads, KV key/value heads (H % KV == 0), head_dim hd; RoPE is
applied before caching, so a ring buffer stays valid whatever its slot
order; softmax in float32.

Full-sequence attention (train, prefill, the encoder, cross-attention
over an encoder output, MLA's train and prefill) goes through
`kernels.ops.flash_attention` (the CUDA kernel on the card, its plain
version on the CPU), where the reference runs its XLA path
`_chunked_attn`. Its gradient is taken through the port of that path
(`_chunked_attn`: query chunks of 512, each recomputed in the backward).
Decode (one token per call),
attention over precomputed cross K/V and the int8 cache's dequantized
keys go through the plain `_grouped_attn`, as in the reference. The caches
are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import ops as kops
from ..sharding.partition import is_partitioned, shard, whole_heads
from .layers import apply_rope, normal

Tensor = torch.Tensor

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: Tensor           # (B, S_slots, KV, hd)   roped keys
    v: Tensor           # (B, S_slots, KV, hd)


class MLACache(NamedTuple):
    c_kv: Tensor        # (B, S_slots, kv_lora_rank)
    k_rope: Tensor      # (B, S_slots, qk_rope_dim)  shared across heads


class QuantKVCache(NamedTuple):
    """int8 KV cache with one float32 scale per (slot, head): half the
    bytes of a bf16 cache for the decode step to read."""
    qk: Tensor          # (B, S_slots, KV, hd) int8
    qv: Tensor          # (B, S_slots, KV, hd) int8
    k_scale: Tensor     # (B, S_slots, KV) float32
    v_scale: Tensor     # (B, S_slots, KV) float32


class CrossKV(NamedTuple):
    """Cross-attention keys and values over the encoder output, computed
    once when a request is admitted (`make_cross_kv`) instead of at every
    decode step."""
    xk: Tensor          # (B, enc_ctx, H, hd)
    xv: Tensor          # (B, enc_ctx, H, hd)


def _quantize(x: Tensor) -> Tuple[Tensor, Tensor]:
    """x (B, S, KV, hd) -> (int8 codes, scales (B, S, KV)), in float32: the
    scale is max |x| / 127 over hd, at least 1e-8; codes round half to
    even."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize(q: Tensor, scale: Tensor, dtype: torch.dtype) -> Tensor:
    return (q.float() * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

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


class MLA(nn.Module):
    """Multi-head latent attention (MiniCPM3): queries through a rank
    q_lora_rank bottleneck, keys and values decompressed per head from a
    rank kv_lora_rank latent, plus one roped key shared by every head."""

    def __init__(self, gen: torch.Generator, d_model: int, n_heads: int,
                 q_lora_rank: int, kv_lora_rank: int, qk_nope_dim: int,
                 qk_rope_dim: int, v_head_dim: int, dtype: torch.dtype):
        super().__init__()
        sd = 0.02
        qk_dim = qk_nope_dim + qk_rope_dim
        self.wq_a = normal(gen, (d_model, q_lora_rank), sd, dtype)
        self.wq_b = normal(gen, (q_lora_rank, n_heads, qk_dim), sd, dtype)
        self.wkv_a = normal(gen, (d_model, kv_lora_rank), sd, dtype)
        # decompression: the latent -> per head (k_nope | v)
        self.wkv_b = normal(gen, (kv_lora_rank, n_heads,
                                  qk_nope_dim + v_head_dim), sd, dtype)
        self.wk_rope = normal(gen, (d_model, qk_rope_dim), sd, dtype)
        self.wo = normal(gen, (n_heads, v_head_dim, d_model), sd, dtype)


def init_mla(gen: torch.Generator, d_model: int, n_heads: int,
             q_lora_rank: int, kv_lora_rank: int, qk_nope_dim: int,
             qk_rope_dim: int, v_head_dim: int,
             dtype: torch.dtype = torch.bfloat16) -> MLA:
    return MLA(gen, d_model, n_heads, q_lora_rank, kv_lora_rank, qk_nope_dim,
               qk_rope_dim, v_head_dim, dtype)


def init_kv_cache(batch: int, slots: int, kv_heads: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16, quantized: bool = False,
                  device=None) -> Union[KVCache, QuantKVCache]:
    shp = (batch, slots, kv_heads, head_dim)
    if quantized:
        return QuantKVCache(
            qk=torch.zeros(shp, dtype=torch.int8, device=device),
            qv=torch.zeros(shp, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shp[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shp[:-1], dtype=torch.float32, device=device))
    return KVCache(k=torch.zeros(shp, dtype=dtype, device=device),
                   v=torch.zeros(shp, dtype=dtype, device=device))


def init_mla_cache(batch: int, slots: int, kv_lora_rank: int,
                   qk_rope_dim: int, dtype: torch.dtype = torch.bfloat16,
                   device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, slots, kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, slots, qk_rope_dim), dtype=dtype,
                           device=device))


def make_cross_kv(p: Attention, enc_out: Tensor) -> CrossKV:
    """Cross-attention K/V over the encoder output (once per request)."""
    xk = _project(enc_out, p.wk)
    xv = _project(enc_out, p.wv)
    if p.bk is not None:
        xk = xk + p.bk
        xv = xv + p.bv
    return CrossKV(xk=xk, xv=xv)


def _ring_slots(S: int, slots: int, device) -> Tuple[int, Tensor]:
    """Block prefill over positions 0..S-1 into `slots` slots: the first
    position kept and the slot of each kept one (pos % slots)."""
    first = max(S - slots, 0)
    return first, torch.arange(first, S, device=device) % slots


def _fill_cache(cache: Union[KVCache, QuantKVCache], k: Tensor, v: Tensor
                ) -> Union[KVCache, QuantKVCache]:
    """Block prefill: write the S roped K/V positions 0..S-1 into the cache,
    in place. A ring cache keeps the last `slots` positions at slot
    pos % slots; an int8 cache quantizes on write."""
    quant = isinstance(cache, QuantKVCache)
    slots = (cache.qk if quant else cache.k).shape[1]
    first, slot_idx = _ring_slots(k.shape[1], slots, k.device)
    kk, vv = k[:, first:], v[:, first:]
    if quant:
        qk, ks = _quantize(kk)
        qv, vs = _quantize(vv)
        cache.qk[:, slot_idx] = qk
        cache.qv[:, slot_idx] = qv
        cache.k_scale[:, slot_idx] = ks
        cache.v_scale[:, slot_idx] = vs
        return cache
    cache.k[:, slot_idx] = kk.to(cache.k.dtype)
    cache.v[:, slot_idx] = vv.to(cache.v.dtype)
    return cache


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------

def _project(x: Tensor, w: Tensor) -> Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product (in a partitioned
    pass, the weight's head width gathered first where it is split:
    `whole_heads`)."""
    D, H, K = w.shape
    w = whole_heads(w, 2)
    return torch.matmul(x, w.reshape(D, H * K)).unflatten(-1, (H, K))


def _out(o: Tensor, wo: Tensor) -> Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product (the weight as in
    `_project`)."""
    H, K, D = wo.shape
    wo = whole_heads(wo, 1)
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


def _attn_chunk(qi: Tensor, kh: Tensor, vh: Tensor, q0: int, causal: bool,
                window: Optional[int], scale: float) -> Tensor:
    """One query chunk of `_chunked_attn`: qi (B,c,H,hd) at positions q0..,
    kh/vh (B,T,H,*) -> (B,c,H,vd)."""
    scores = torch.einsum("bchd,bthd->bhct", qi, kh).float() * scale
    scores = shard(scores, "batch", "heads", None, None)
    if causal:
        qpos = q0 + torch.arange(qi.shape[1], device=qi.device)[:, None]
        kpos = torch.arange(kh.shape[1], device=qi.device)[None, :]
        ok = kpos <= qpos
        if window is not None:
            ok = ok & (kpos > qpos - window)
        scores = torch.where(ok, scores,
                             torch.full((), NEG_INF, device=qi.device))
    probs = torch.softmax(scores, dim=-1).to(vh.dtype)
    return torch.einsum("bhct,bthd->bchd", probs, vh)


def _chunked_attn(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                  window: Optional[int], scale: float,
                  chunk: int = 512) -> Tensor:
    """The reference's train/prefill attention (`_chunked_attn`): KV heads
    broadcast to H, queries in chunks of `chunk`, each chunk's scores in
    float32 and its probabilities cast to v's dtype; each chunk is
    checkpointed, so a backward recomputes one chunk's scores at a time
    (the reference's `jax.checkpoint` per chunk). q (B,S,H,hd), k/v
    (B,T,KV,*) -> (B,S,H,vd). The flash kernel's gradient is taken through
    it; the last chunk is short instead of padded."""
    S, H = q.shape[1], q.shape[2]
    G = H // k.shape[2]
    kh = shard(k.repeat_interleave(G, dim=2), "batch", "seq", "heads",
               "head_dim")
    vh = shard(v.repeat_interleave(G, dim=2), "batch", "seq", "heads",
               "head_dim")
    c = min(chunk, S)
    return torch.cat([checkpoint(_attn_chunk, q[:, q0:q0 + c], kh, vh, q0,
                                 causal, window, scale, use_reentrant=False)
                      for q0 in range(0, S, c)], dim=1)


def _chunked_attn_heads_first(q: Tensor, k: Tensor, v: Tensor, *,
                              causal: bool, window: Optional[int],
                              scale: float) -> Tensor:
    """`_chunked_attn` on the kernel's layout (B, heads, S, *)."""
    return _chunked_attn(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window,
                         scale=scale).transpose(1, 2)


def _flash(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
           window: Optional[int], scale: float) -> Tensor:
    """The flash kernel on the model's layout: q (B,S,H,hd), k/v
    (B,T,KV,*) -> (B,S,H,vd), differentiable through `_chunked_attn`. In a
    partitioned pass K/V are first repeated to q's heads and laid out like
    them, as the reference's `_chunked_attn` does, so that the op's heads
    split alike (`kernels.ops.register_sharding_rules`)."""
    if k.shape[2] != q.shape[2] and is_partitioned(q):
        G = q.shape[2] // k.shape[2]
        k, v = (shard(t.repeat_interleave(G, dim=2), "batch", "seq", "heads",
                      "head_dim") for t in (k, v))
    out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window if causal else None,
                               scale=scale,
                               backward=_chunked_attn_heads_first)
    return out.transpose(1, 2)


def _decode_valid(slots: int, pos: int, window: Optional[int],
                  device) -> Tensor:
    """(1, 1, 1, 1, slots) boolean: the cache slots a decode step at `pos`
    attends to."""
    kpos = torch.arange(slots, device=device)
    if window is not None:
        valid = (kpos <= pos % slots) | (pos >= slots)
    else:
        valid = kpos <= pos
    return valid[None, None, None, None, :]


# ---------------------------------------------------------------------------
# GQA forward (prefill / decode / cross)
# ---------------------------------------------------------------------------

def attention(p: Attention, x: Tensor, *, positions: Optional[Tensor] = None,
              mode: str = "train",
              cache: Union[KVCache, QuantKVCache, None] = None,
              pos: Union[int, Tensor, None] = None,
              window: Optional[int] = None, causal: bool = True,
              rope_theta: float = 10000.0, kv_x: Optional[Tensor] = None,
              cross_kv: Optional[CrossKV] = None, use_rope: bool = True
              ) -> Tuple[Tensor, Union[KVCache, QuantKVCache, None]]:
    """Returns (out (B, S, D), new_cache).

    mode "train" / "prefill": full-sequence self-attention (the flash
        kernel); "prefill" also fills `cache` when one is given.
    mode "decode": S == 1; writes `cache` at absolute position `pos`
        (ring-buffered when `window` is set; quantized for an int8 cache)
        and attends over it.
    kv_x: cross-attention over this source (B, T, D), in any mode: the
        flash kernel, non-causal, no RoPE, no cache.
    cross_kv: cross-attention over precomputed K/V (`make_cross_kv`): the
        plain `_grouped_attn`, no mask.
    """
    B, S, D = x.shape
    hd = p.wq.shape[2]
    scale = hd ** -0.5

    q = _project(x, p.wq)
    if p.bq is not None:
        q = q + p.bq
    if cross_kv is not None:
        out = _grouped_attn(q, cross_kv.xk, cross_kv.xv, None, scale)
        return _out(out, p.wo), None

    src = x if kv_x is None else kv_x
    k = _project(src, p.wk)
    v = _project(src, p.wv)
    if p.bk is not None:
        k = k + p.bk
        v = v + p.bv
    q = shard(q, "batch", "seq", "heads", "head_dim")
    k = shard(k, "batch", "seq", "kv_heads", "head_dim")

    if kv_x is not None:
        out = _flash(q, k, v, causal=False, window=None, scale=scale)
        return _out(out, p.wo), None

    if mode in ("train", "prefill"):
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        if use_rope:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
        out = _flash(q, k, v, causal=causal, window=window, scale=scale)
        new_cache = None
        if mode == "prefill" and cache is not None:
            new_cache = _fill_cache(cache, k, v)
        return _out(out, p.wo), new_cache

    # ---- decode -----------------------------------------------------------
    if S != 1 or cache is None or pos is None:
        raise ValueError("attention: decode takes one token, a cache and pos")
    pos = int(pos)
    if use_rope:
        pv = torch.full((B, 1), pos, device=x.device)
        q = apply_rope(q, pv, rope_theta)
        k = apply_rope(k, pv, rope_theta)
    quant = isinstance(cache, QuantKVCache)
    slots = (cache.qk if quant else cache.k).shape[1]
    slot = pos % slots if window is not None else pos
    if quant:
        qk, ks = _quantize(k)
        qv, vs = _quantize(v)
        cache.qk[:, slot] = qk[:, 0]
        cache.qv[:, slot] = qv[:, 0]
        cache.k_scale[:, slot] = ks[:, 0]
        cache.v_scale[:, slot] = vs[:, 0]
        k_all = _dequantize(
            shard(cache.qk, "batch", "kv_seq", "kv_heads", "head_dim"),
            shard(cache.k_scale, "batch", "kv_seq", "kv_heads"), k.dtype)
        v_all = _dequantize(
            shard(cache.qv, "batch", "kv_seq", "kv_heads", "head_dim"),
            shard(cache.v_scale, "batch", "kv_seq", "kv_heads"), v.dtype)
    else:
        cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
        k_all = shard(cache.k, "batch", "kv_seq", "kv_heads", "head_dim")
        v_all = shard(cache.v, "batch", "kv_seq", "kv_heads", "head_dim")
    out = _grouped_attn(q, k_all, v_all,
                        _decode_valid(slots, pos, window, x.device), scale)
    return _out(out, p.wo), cache


# ---------------------------------------------------------------------------
# MLA forward (MiniCPM3-style multi-head latent attention)
# ---------------------------------------------------------------------------

def mla_attention(p: MLA, x: Tensor, *, qk_nope_dim: int, qk_rope_dim: int,
                  v_head_dim: int, mode: str = "train",
                  cache: Optional[MLACache] = None,
                  pos: Union[int, Tensor, None] = None,
                  window: Optional[int] = None, rope_theta: float = 10000.0
                  ) -> Tuple[Tensor, Optional[MLACache]]:
    """Latent attention: the decode cache holds the rank-r latent c_kv and
    the shared roped key, not per-head K/V. Prefill runs the flash kernel
    on concat(q_nope, q_rope) against concat(k_nope, k_rope) with values of
    width v_head_dim; decode decompresses the whole latent cache with
    wkv_b and runs the plain `_grouped_attn`."""
    B, S, D = x.shape
    H = p.wq_b.shape[1]
    scale = (qk_nope_dim + qk_rope_dim) ** -0.5

    q = _project(torch.matmul(x, p.wq_a), p.wq_b)
    q_nope, q_rope = q[..., :qk_nope_dim], q[..., qk_nope_dim:]
    c_kv = torch.matmul(x, p.wkv_a)                     # latent
    k_rope = torch.matmul(x, p.wk_rope)                 # shared rope key

    if mode in ("train", "prefill"):
        positions = torch.arange(S, device=x.device)[None, :]
        q_rope = apply_rope(q_rope, positions, rope_theta)
        k_rope_r = apply_rope(k_rope[:, :, None, :], positions,
                              rope_theta)[:, :, 0]
        kv = _project(c_kv, p.wkv_b)
        k_nope, v = kv[..., :qk_nope_dim], kv[..., qk_nope_dim:]
        k = torch.cat([k_nope, k_rope_r[:, :, None, :].expand(
            B, S, H, qk_rope_dim)], dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        out = _flash(qf, k, v, causal=True, window=window, scale=scale)
        new_cache = None
        if mode == "prefill" and cache is not None:
            first, idx = _ring_slots(S, cache.c_kv.shape[1], x.device)
            cache.c_kv[:, idx] = c_kv[:, first:].to(cache.c_kv.dtype)
            cache.k_rope[:, idx] = k_rope_r[:, first:].to(cache.k_rope.dtype)
            new_cache = cache
        return _out(out, p.wo), new_cache

    if S != 1 or cache is None or pos is None:
        raise ValueError("mla_attention: decode takes one token, a cache and "
                         "pos")
    pos = int(pos)
    pv = torch.full((B, 1), pos, device=x.device)
    q_rope = apply_rope(q_rope, pv, rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], pv, rope_theta)[:, :, 0]
    slots = cache.c_kv.shape[1]
    slot = pos % slots if window is not None else pos
    cache.c_kv[:, slot] = c_kv[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[:, slot] = k_rope[:, 0].to(cache.k_rope.dtype)

    kv = _project(cache.c_kv, p.wkv_b)              # decompress
    k_nope, v = kv[..., :qk_nope_dim], kv[..., qk_nope_dim:]
    k = torch.cat([k_nope, cache.k_rope[:, :, None, :].expand(
        B, slots, H, qk_rope_dim)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    out = _grouped_attn(qf, k, v, _decode_valid(slots, pos, window, x.device),
                        scale)
    return _out(out, p.wo), cache
