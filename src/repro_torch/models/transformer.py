"""The model stack for serving: embedding, layer periods, head.

Port of `repro/models/transformer.py` for the layer kinds `attn` (GQA
self-attention + SwiGLU MLP), `attn_moe` (the same with a MoE in place of
the MLP), `mamba` / `mamba_moe` (the Mamba mixer + MLP or MoE) and `rwkv`
(RWKV6 time mix + channel mix).
A config's `block_pattern` lists the kinds of one period; the reference
stacks each slot's parameters over periods and runs them under
`jax.lax.scan`, the port keeps one module per layer (`Model.layers[i]` is
period i, a `ModuleDict` keyed like the reference's period dict, e.g.
"s0_attn") and loops over them in Python. Parameter names mirror the JAX
leaves: `layers.3.s0_attn.attn.wq` is `params["layers"]["s0_attn"]["attn"]
["wq"][3]`.

Modes: "prefill" (full sequence, fills the decode cache; the flash,
mamba and rwkv6 kernels run here) and "decode" (one token per call against
the cache, plain torch). MLA, cross-attention, encoders, the int8 KV cache
and patch prefixes are not ported and raise `NotImplementedError`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core.types import resolve_device
from . import attention as attn_lib
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import (MLP, Embed, LMHead, RMSNorm, apply_mlp, embed_tokens,
                     lm_logits, rms_norm)

Tensor = torch.Tensor
Cache = List[Dict[str, object]]

PORTED_KINDS = ("attn", "attn_moe", "mamba", "mamba_moe", "rwkv")


def unported(cfg: ModelConfig) -> List[str]:
    """What of `cfg` this port cannot run yet: layer kinds outside
    PORTED_KINDS and the attention options it lacks."""
    out = sorted({k for k in cfg.block_pattern if k not in PORTED_KINDS})
    if cfg.attention == "mla" and any(k.startswith("attn")
                                      for k in cfg.block_pattern):
        out.append("attention=mla")
    if cfg.kv_cache_int8:
        out.append("kv_cache_int8")
    if cfg.encoder_layers:
        out.append("encoder")
    if cfg.n_patches:
        out.append("patch prefix")
    return out


def check_ported(cfg: ModelConfig):
    missing = unported(cfg)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (the port runs "
            f"layer kinds {', '.join(PORTED_KINDS)}; ROADMAP.md, Queue 1 "
            "item 12)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class Sublayer(nn.Module):
    def __init__(self, kind: str, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        dev, dt = gen.device, cfg.torch_dtype
        self.norm1 = RMSNorm(cfg.d_model, dev)
        self.norm2 = RMSNorm(cfg.d_model, dev)
        if kind in ("attn", "attn_moe"):
            self.attn = attn_lib.init_attention(
                gen, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim,
                cfg.qkv_bias, dt)
        elif kind in ("mamba", "mamba_moe"):
            self.mamba = ssm_lib.Mamba(gen, cfg.d_model, cfg.d_inner,
                                       cfg.d_state, cfg.d_conv, dtype=dt)
        elif kind == "rwkv":
            self.rwkv = ssm_lib.RWKV(gen, cfg.d_model, cfg.n_heads,
                                     cfg.head_dim, cfg.d_ff, dt)
        else:
            raise NotImplementedError(f"layer kind {kind!r} not ported yet")
        if kind.endswith("_moe"):
            self.moe = moe_lib.MoE(gen, cfg.d_model, cfg.d_ff,
                                   cfg.n_experts, dt)
        elif kind != "rwkv":
            self.mlp = MLP(gen, cfg.d_model, cfg.d_ff, dt)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.embed = Embed(gen, cfg.vocab_size, cfg.d_model, cfg.torch_dtype)
        self.lm_head = None if cfg.tied_embeddings else LMHead(
            gen, cfg.d_model, cfg.vocab_size, cfg.torch_dtype)
        self.final_norm = RMSNorm(cfg.d_model, gen.device)
        self.layers = nn.ModuleList(
            nn.ModuleDict({f"s{i}_{kind}": Sublayer(kind, gen, cfg)
                           for i, kind in enumerate(cfg.block_pattern)})
            for _ in range(cfg.n_periods))


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """Random weights from `seed`, drawn on `device` one tensor at a time
    (no float32 copy of the whole model), with the reference's
    distributions and scales."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return Model(cfg, gen)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> Cache:
    """One dict per period, keyed like its layers. Sliding-window attention
    gets a ring buffer of `window` slots, full attention `max_seq` slots,
    Mamba and RWKV layers their O(1) state."""
    check_ported(cfg)
    out = []
    for _ in range(cfg.n_periods):
        c = {}
        for i, kind in enumerate(cfg.block_pattern):
            nm = f"s{i}_{kind}"
            if kind in ("attn", "attn_moe"):
                slots = min(cfg.sliding_window, max_seq) \
                    if cfg.sliding_window else max_seq
                c[nm] = attn_lib.init_kv_cache(
                    batch, slots, cfg.kv_heads, cfg.head_dim,
                    cfg.torch_dtype, quantized=cfg.kv_cache_int8,
                    device=device)
            elif kind in ("mamba", "mamba_moe"):
                c[nm] = ssm_lib.init_mamba_cache(
                    batch, cfg.d_inner, cfg.d_state, cfg.d_conv,
                    cfg.torch_dtype, device=device)
            else:
                c[nm] = ssm_lib.init_rwkv_cache(batch, cfg.d_model,
                                                cfg.n_heads, cfg.head_dim,
                                                device=device)
        out.append(c)
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _ffn(kind: str, p: Sublayer, cfg: ModelConfig, x: Tensor
         ) -> Tuple[Tensor, Optional[Tensor]]:
    """x plus the MLP, or the MoE for `*_moe` kinds, of its norm. Returns
    (x, the MoE aux loss or None)."""
    h = rms_norm(x, p.norm2.scale, cfg.norm_eps)
    if kind.endswith("_moe"):
        o, aux = moe_lib.apply_moe(p.moe, h, cfg.top_k, cfg.capacity_factor)
        return x + o, aux
    return x + apply_mlp(p.mlp, h), None


def _sublayer(kind: str, p: Sublayer, cfg: ModelConfig, x: Tensor, *,
              mode: str, cache, pos
              ) -> Tuple[Tensor, object, Optional[Tensor]]:
    """Apply one sublayer. Returns (x, new_cache, MoE aux loss or None)."""
    if kind in ("attn", "attn_moe"):
        h = rms_norm(x, p.norm1.scale, cfg.norm_eps)
        o, new_c = attn_lib.attention(
            p.attn, h, mode=mode, cache=cache, pos=pos,
            window=cfg.sliding_window, causal=True,
            rope_theta=cfg.rope_theta)
        x, aux = _ffn(kind, p, cfg, x + o)
        return x, new_c, aux

    if kind in ("mamba", "mamba_moe"):
        h = rms_norm(x, p.norm1.scale, cfg.norm_eps)
        o, new_c = ssm_lib.mamba(p.mamba, h, mode=mode, cache=cache)
        x, aux = _ffn(kind, p, cfg, x + o)
        return x, new_c, aux

    if kind == "rwkv":
        h = rms_norm(x, p.norm1.scale, cfg.norm_eps)
        o, state, x_tm = ssm_lib.rwkv_time_mix(
            p.rwkv.part("tm_"), h, n_heads=cfg.n_heads,
            head_dim=cfg.head_dim, mode=mode, cache=cache,
            chunk=cfg.rwkv_chunk)
        x = x + o
        h = rms_norm(x, p.norm2.scale, cfg.norm_eps)
        o, x_cm = ssm_lib.rwkv_channel_mix(
            p.rwkv.part("cm_"), h, mode=mode,
            x_prev=cache.x_cm if (mode == "decode" and cache is not None)
            else None)
        x = x + o
        new_c = ssm_lib.RWKVCache(state=state,
                                  x_tm=x_tm.to(torch.bfloat16),
                                  x_cm=x_cm.to(torch.bfloat16))
        return x, new_c, None

    raise NotImplementedError(f"layer kind {kind!r} not ported yet")


def model_forward(model: Model, cfg: ModelConfig, batch: Dict[str, Tensor],
                  *, mode: str = "prefill", cache: Optional[Cache] = None,
                  pos: Union[int, Tensor, None] = None
                  ) -> Tuple[Tensor, Tensor, Optional[Cache]]:
    """Returns (logits (B, S, V) float32, the MoE layers' summed aux loss
    (float32, 0 without MoE), new cache).

    batch: {"tokens": (B, S)}."""
    x = embed_tokens(model.embed, batch["tokens"]).to(cfg.torch_dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = [] if cache is not None else None
    for i, period in enumerate(model.layers):
        new_cs = {}
        for nm, p in period.items():
            kind = nm.split("_", 1)[1]
            c_in = cache[i][nm] if cache is not None else None
            x, c_out, a = _sublayer(kind, p, cfg, x, mode=mode, cache=c_in,
                                    pos=pos)
            if a is not None:
                aux = aux + a
            new_cs[nm] = c_out if c_out is not None else c_in
        if new_cache is not None:
            new_cache.append(new_cs)
    x = rms_norm(x, model.final_norm.scale, cfg.norm_eps)
    logits = lm_logits(model.embed, model.lm_head, x)
    return logits, aux, new_cache


@torch.no_grad()
def prefill(model: Model, cfg: ModelConfig, batch: Dict[str, Tensor],
            cache: Cache) -> Tuple[Tensor, Cache]:
    """Block prefill: one full-sequence forward that also fills the decode
    cache (attention K/V slots, Mamba conv tails and states, RWKV states).
    Returns (logits, cache). Continue with serve_step(..., pos=prompt_len).
    Any prompt length: the mamba scan runs over the whole sequence, and the
    rwkv scan pads its last chunk with state-preserving lanes."""
    logits, _, new_cache = model_forward(model, cfg, batch, mode="prefill",
                                         cache=cache)
    return logits, new_cache


@torch.no_grad()
def serve_step(model: Model, cfg: ModelConfig, cache: Cache, token: Tensor,
               pos: Union[int, Tensor]) -> Tuple[Tensor, Cache]:
    """One decode step: token (B,) at absolute position `pos` ->
    (logits (B, V), new cache)."""
    logits, _, new_cache = model_forward(model, cfg,
                                         {"tokens": token[:, None]},
                                         mode="decode", cache=cache, pos=pos)
    return logits[:, 0], new_cache
