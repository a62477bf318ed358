"""The model stack: embedding, layer periods, encoder, head.

Port of `repro/models/transformer.py` for every layer kind: `attn` (GQA
or MLA self-attention + SwiGLU MLP), `attn_moe` (the same with a MoE in
place of the MLP), `attn_cross` (decoder self-attention, cross-attention
over the encoder output, MLP), `enc_attn` (the encoder's non-causal
self-attention, no RoPE), `mamba` / `mamba_moe` (the Mamba mixer + MLP or
MoE) and `rwkv` (RWKV6 time mix + channel mix).
A config's `block_pattern` lists the kinds of one period; the reference
stacks each slot's parameters over periods and runs them under
`jax.lax.scan`, the port keeps one module per layer (`Model.layers[i]` is
period i, a `ModuleDict` keyed like the reference's period dict, e.g.
"s0_attn"; `Model.encoder[i]` is encoder layer i) and loops over them in
Python. Parameter names mirror the JAX leaves: `layers.3.s0_attn.attn.wq`
is `params["layers"]["s0_attn"]["attn"]["wq"][3]`, `encoder.5.attn.wq` is
`params["encoder"]["attn"]["wq"][5]`.

Modes: "train" (full sequence, returns logits and the MoE aux loss; the
flash, mamba and rwkv6 kernels run forward, their gradients are taken
through the reference's training formulations, and with `cfg.remat` each
period is checkpointed: recomputed in the backward, every kernel of it
included), "prefill" (the same forward, no gradient; fills the decode
cache) and "decode" (one token per call against the cache, plain torch,
except the encoder and the cross-attention over its output when frames
are passed to every step, as the reference's default decode does).
Encoder-decoder requests can instead run the encoder once at admission
(`prepare_cross_cache`) and decode against cached cross K/V. `lm_loss` is
the training loss; `param_tree` gives the parameters (or any tensors
named like them, such as an optimizer's moments) in the reference's tree
layout, stacked over periods.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Mapping, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..core.types import resolve_device
from ..sharding.partition import shard
from . import attention as attn_lib
from . import moe as moe_lib
from . import ssm as ssm_lib
from .layers import (MLP, Embed, LMHead, MetaGenerator, RMSNorm, apply_mlp,
                     embed_tokens, lm_logits, rms_norm, softmax_xent)

Tensor = torch.Tensor
Cache = List[Dict[str, object]]

ATTN_KINDS = ("attn", "attn_moe", "enc_attn", "attn_cross")


def _is_mla(kind: str, cfg: ModelConfig) -> bool:
    """MLA replaces every attention but the encoder's."""
    return cfg.attention == "mla" and kind != "enc_attn"


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class Sublayer(nn.Module):
    def __init__(self, kind: str, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        dev, dt = gen.device, cfg.torch_dtype
        self.norm1 = RMSNorm(cfg.d_model, dev)
        self.norm2 = RMSNorm(cfg.d_model, dev)
        if kind in ATTN_KINDS:
            if _is_mla(kind, cfg):
                self.attn = attn_lib.init_mla(
                    gen, cfg.d_model, cfg.n_heads, cfg.q_lora_rank,
                    cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                    cfg.v_head_dim, dt)
            else:
                self.attn = attn_lib.init_attention(
                    gen, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                    cfg.head_dim, cfg.qkv_bias, dt)
            if kind == "attn_cross":
                self.xattn = attn_lib.init_attention(
                    gen, cfg.d_model, cfg.n_heads, cfg.n_heads, cfg.head_dim,
                    False, dt)
                self.norm3 = RMSNorm(cfg.d_model, dev)
        elif kind in ("mamba", "mamba_moe"):
            self.mamba = ssm_lib.Mamba(gen, cfg.d_model, cfg.d_inner,
                                       cfg.d_state, cfg.d_conv, dtype=dt)
        elif kind == "rwkv":
            self.rwkv = ssm_lib.RWKV(gen, cfg.d_model, cfg.n_heads,
                                     cfg.head_dim, cfg.d_ff, dt)
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        if kind.endswith("_moe"):
            self.moe = moe_lib.MoE(gen, cfg.d_model, cfg.d_ff,
                                   cfg.n_experts, dt)
        elif kind != "rwkv":
            self.mlp = MLP(gen, cfg.d_model, cfg.d_ff, dt)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(gen, cfg.vocab_size, cfg.d_model, cfg.torch_dtype)
        self.lm_head = None if cfg.tied_embeddings else LMHead(
            gen, cfg.d_model, cfg.vocab_size, cfg.torch_dtype)
        self.final_norm = RMSNorm(cfg.d_model, gen.device)
        self.layers = nn.ModuleList(
            nn.ModuleDict({f"s{i}_{kind}": Sublayer(kind, gen, cfg)
                           for i, kind in enumerate(cfg.block_pattern)})
            for _ in range(cfg.n_periods))
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(
                Sublayer("enc_attn", gen, cfg)
                for _ in range(cfg.encoder_layers))
            self.enc_final_norm = RMSNorm(cfg.d_model, gen.device)
        else:
            self.encoder = self.enc_final_norm = None


def init_model(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """Random weights from `seed`, drawn on `device` one tensor at a time
    (no float32 copy of the whole model), with the reference's
    distributions and scales. On "meta" nothing is drawn: every parameter
    is an empty meta tensor with the CPU build's name, shape and dtype
    (the reference's `jax.eval_shape(init_model)`)."""
    dev = resolve_device(device)
    gen = MetaGenerator() if dev.type == "meta" \
        else torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return Model(cfg, gen)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> Cache:
    """One dict per period, keyed like its layers. Sliding-window attention
    gets a ring buffer of `window` slots, full attention `max_seq` slots
    (MLA its latent cache; int8 codes and scales with `kv_cache_int8`),
    Mamba and RWKV layers their O(1) state. With `cross_kv_cache`, an
    `attn_cross` slot is {"self": its KV cache, "cross": a zero CrossKV}
    that `prepare_cross_cache` fills."""
    dt = cfg.torch_dtype
    out = []
    for _ in range(cfg.n_periods):
        c = {}
        for i, kind in enumerate(cfg.block_pattern):
            nm = f"s{i}_{kind}"
            if kind in ("attn", "attn_moe", "attn_cross"):
                slots = min(cfg.sliding_window, max_seq) \
                    if cfg.sliding_window else max_seq
                if _is_mla(kind, cfg):
                    c[nm] = attn_lib.init_mla_cache(
                        batch, slots, cfg.kv_lora_rank, cfg.qk_rope_dim, dt,
                        device=device)
                else:
                    c[nm] = attn_lib.init_kv_cache(
                        batch, slots, cfg.kv_heads, cfg.head_dim, dt,
                        quantized=cfg.kv_cache_int8, device=device)
                if kind == "attn_cross" and cfg.cross_kv_cache:
                    shp = (batch, cfg.encoder_ctx, cfg.n_heads, cfg.head_dim)
                    c[nm] = {"self": c[nm], "cross": attn_lib.CrossKV(
                        xk=torch.zeros(shp, dtype=dt, device=device),
                        xv=torch.zeros(shp, dtype=dt, device=device))}
            elif kind in ("mamba", "mamba_moe"):
                c[nm] = ssm_lib.init_mamba_cache(
                    batch, cfg.d_inner, cfg.d_state, cfg.d_conv, dt,
                    device=device)
            elif kind == "rwkv":
                c[nm] = ssm_lib.init_rwkv_cache(batch, cfg.d_model,
                                                cfg.n_heads, cfg.head_dim,
                                                device=device)
            else:
                raise ValueError(f"init_cache: no cache for layer kind "
                                 f"{kind!r}")
        out.append(c)
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _gathered(x: Tensor) -> Tensor:
    """`x` (B, S, D) with no split of its sequence or width: outside a
    partitioned pass, `x` itself. Around each block the reference's GSPMD
    gathers the residual stream's sequence split ("seq_outer") into the
    block and reduces the block's partial sums back out of it; DTensor
    inserts nothing, so the models constrain a block's normed input and
    its output (and the LM head's input) here. Without it a matrix
    product flattens a sequence split over one mesh axis with a batch
    split over another (a strided layout), forward or backward, whose
    redistributions DTensor plans by a slow search over layouts, and the
    ops around it split less evenly than the batch."""
    return shard(x, "batch", "seq", "embed_act")


def _branch_input(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    """A block's (or the LM head's) normed input, `_gathered`."""
    return _gathered(rms_norm(x, scale, eps))


def _ffn(kind: str, p: Sublayer, cfg: ModelConfig, x: Tensor
         ) -> Tuple[Tensor, Optional[Tensor]]:
    """x plus the MLP, or the MoE for `*_moe` kinds, of its norm. Returns
    (x, the MoE aux loss or None)."""
    h = _branch_input(x, p.norm2.scale, cfg.norm_eps)
    if kind.endswith("_moe"):
        o, aux = moe_lib.apply_moe(p.moe, h, cfg.top_k, cfg.capacity_factor)
        return x + _gathered(o), aux
    return x + _gathered(apply_mlp(p.mlp, h)), None


def _sublayer(kind: str, p: Sublayer, cfg: ModelConfig, x: Tensor, *,
              mode: str, cache, pos, enc_out: Optional[Tensor] = None
              ) -> Tuple[Tensor, object, Optional[Tensor]]:
    """Apply one sublayer. Returns (x, new_cache, MoE aux loss or None)."""
    if kind in ATTN_KINDS:
        cross_c = None
        if kind == "attn_cross" and isinstance(cache, dict):
            cross_c, cache = cache["cross"], cache["self"]
        h = _branch_input(x, p.norm1.scale, cfg.norm_eps)
        if _is_mla(kind, cfg):
            o, new_c = attn_lib.mla_attention(
                p.attn, h, qk_nope_dim=cfg.qk_nope_dim,
                qk_rope_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim,
                mode=mode, cache=cache, pos=pos, window=cfg.sliding_window,
                rope_theta=cfg.rope_theta)
        else:
            enc = kind == "enc_attn"
            o, new_c = attn_lib.attention(
                p.attn, h, mode=mode, cache=cache, pos=pos,
                window=None if enc else cfg.sliding_window, causal=not enc,
                rope_theta=cfg.rope_theta, use_rope=not enc)
        x = x + _gathered(o)
        if kind == "attn_cross":
            h = _branch_input(x, p.norm3.scale, cfg.norm_eps)
            if cross_c is not None:
                o, _ = attn_lib.attention(p.xattn, h, mode="train",
                                          cross_kv=cross_c, causal=False)
            elif enc_out is not None:
                o, _ = attn_lib.attention(p.xattn, h, mode="train",
                                          kv_x=enc_out, causal=False)
            else:
                raise ValueError(
                    "attn_cross: no encoder output; pass frame_embeds or "
                    "enc_out, or decode against a cache filled by "
                    "prepare_cross_cache")
            x = x + _gathered(o)
        x, aux = _ffn(kind, p, cfg, x)
        if cross_c is not None:
            return x, {"self": new_c, "cross": cross_c}, aux
        return x, new_c, aux

    if kind in ("mamba", "mamba_moe"):
        h = _branch_input(x, p.norm1.scale, cfg.norm_eps)
        o, new_c = ssm_lib.mamba(p.mamba, h, mode=mode, cache=cache,
                                 chunk=cfg.ssm_chunk)
        x, aux = _ffn(kind, p, cfg, x + _gathered(o))
        return x, new_c, aux

    if kind == "rwkv":
        h = _branch_input(x, p.norm1.scale, cfg.norm_eps)
        o, state, x_tm = ssm_lib.rwkv_time_mix(
            p.rwkv.part("tm_"), h, n_heads=cfg.n_heads,
            head_dim=cfg.head_dim, mode=mode, cache=cache,
            chunk=cfg.rwkv_chunk)
        x = x + _gathered(o)
        h = _branch_input(x, p.norm2.scale, cfg.norm_eps)
        o, x_cm = ssm_lib.rwkv_channel_mix(
            p.rwkv.part("cm_"), h, mode=mode,
            x_prev=cache.x_cm if (mode == "decode" and cache is not None)
            else None)
        x = x + _gathered(o)
        new_c = ssm_lib.RWKVCache(state=state,
                                  x_tm=x_tm.to(torch.bfloat16),
                                  x_cm=x_cm.to(torch.bfloat16))
        return x, new_c, None

    raise ValueError(f"unknown layer kind {kind!r}")


def _encoder_forward(model: Model, cfg: ModelConfig, frames: Tensor
                     ) -> Tensor:
    """The encoder over precomputed frame embeddings (B, T, D) (the audio
    frontend is a stub, as in the reference): sinusoidal positions,
    computed in float32 and added after the cast to the config's dtype,
    then the encoder layers (the flash kernel, non-causal, no RoPE) and
    `enc_final_norm`."""
    if model.encoder is None:
        raise ValueError(f"{cfg.name}: no encoder")
    x = frames.to(cfg.torch_dtype)
    half = cfg.d_model // 2
    pos = torch.arange(x.shape[1], device=x.device, dtype=torch.float32)
    freqs = torch.exp(-torch.arange(half, device=x.device,
                                    dtype=torch.float32)
                      / max(half - 1, 1) * math.log(10000.0))
    ang = pos[:, None] * freqs
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
    x = x + pe[None].to(x.dtype)
    for p in model.encoder:
        x, _, _ = _sublayer("enc_attn", p, cfg, x, mode="train", cache=None,
                            pos=None)
    return rms_norm(x, model.enc_final_norm.scale, cfg.norm_eps)


# matrix products without batch dimensions, the outputs that remat policy
# "dots" keeps (the reference's dots_with_no_batch_dims_saveable)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _period(period: nn.ModuleDict, cfg: ModelConfig, x: Tensor,
            aux: Tensor, *, mode: str, cache: Optional[Dict[str, object]],
            pos, enc_out: Optional[Tensor]
            ) -> Tuple[Tensor, Tensor, Dict[str, object]]:
    """One period's sublayers in order, carrying (x, the aux loss so far),
    as the reference's scan body does: (x, aux, its new cache)."""
    new_cs = {}
    # the residual stream's sequence parallelism (the reference's
    # Megatron-style "seq_outer" split over the model axis)
    x = shard(x, "batch", "seq_outer", "embed_act")
    for nm, p in period.items():
        kind = nm.split("_", 1)[1]
        c_in = cache[nm] if cache is not None else None
        x, c_out, a = _sublayer(kind, p, cfg, x, mode=mode, cache=c_in,
                                pos=pos, enc_out=enc_out)
        if a is not None:
            aux = aux + a
        new_cs[nm] = c_out if c_out is not None else c_in
    return x, aux, new_cs


def _remat_period(period: nn.ModuleDict, cfg: ModelConfig, x: Tensor,
                  aux: Tensor, enc_out: Optional[Tensor]
                  ) -> Tuple[Tensor, Tensor]:
    """A train-mode period under `torch.utils.checkpoint` (non-reentrant):
    its activations are recomputed in the backward ("full"), or all but
    the matrix products' outputs ("dots")."""
    def run(x, aux):
        x, aux, _ = _period(period, cfg, x, aux, mode="train", cache=None,
                            pos=None, enc_out=enc_out)
        return x, aux

    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    elif cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    return checkpoint(run, x, aux, use_reentrant=False, **kw)


def model_forward(model: Model, cfg: ModelConfig, batch: Dict[str, Tensor],
                  *, mode: str = "prefill", cache: Optional[Cache] = None,
                  pos: Union[int, Tensor, None] = None
                  ) -> Tuple[Tensor, Tensor, Optional[Cache]]:
    """Returns (logits (B, S, V) float32, the MoE layers' summed aux loss
    (float32, 0 without MoE), new cache).

    batch: {"tokens": (B, S)} plus, optionally, "enc_out" (a precomputed
    encoder output) or "frame_embeds" (B, encoder_ctx, D) for an encoder
    config, and "patch_embeds" (B, n_patches, D) for a VLM, put before the
    token embeddings except in decode (the logits then cover patches and
    tokens). In "train" mode with `cfg.remat`, each period runs under a
    checkpoint (`cfg.remat_policy`)."""
    x = embed_tokens(model.embed, batch["tokens"]).to(cfg.torch_dtype)
    enc_out = batch.get("enc_out")
    if enc_out is None and cfg.encoder_layers and "frame_embeds" in batch:
        enc_out = _encoder_forward(model, cfg, batch["frame_embeds"])
    if cfg.n_patches and "patch_embeds" in batch and mode != "decode":
        x = torch.cat([batch["patch_embeds"].to(cfg.torch_dtype), x], dim=1)
    x = shard(x, "batch", "seq", "embed_act")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = [] if cache is not None else None
    remat = mode == "train" and cfg.remat and cache is None
    for i, period in enumerate(model.layers):
        if remat:
            x, aux = _remat_period(period, cfg, x, aux, enc_out)
            continue
        x, aux, new_cs = _period(period, cfg, x, aux, mode=mode,
                                 cache=cache[i] if cache is not None
                                 else None, pos=pos, enc_out=enc_out)
        if new_cache is not None:
            new_cache.append(new_cs)
    x = _branch_input(x, model.final_norm.scale, cfg.norm_eps)
    logits = lm_logits(model.embed, model.lm_head, x)
    return logits, aux, new_cache


def lm_loss(model: Model, cfg: ModelConfig, batch: Dict[str, Tensor],
            aux_weight: float = 0.01) -> Tensor:
    """Next-token cross entropy of a "train" forward plus aux_weight times
    the MoE aux loss. Labels are the tokens rolled left by one, the last
    position masked; with patch_embeds the logits of the patch positions
    are dropped."""
    logits, aux, _ = model_forward(model, cfg, batch, mode="train")
    tokens = batch["tokens"]
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
    mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    mask[:, -1] = 0.0
    if cfg.n_patches and "patch_embeds" in batch:
        logits = logits[:, cfg.n_patches:]
    return softmax_xent(logits, labels, mask) + aux_weight * aux


# the parameter groups the reference stacks over layers on axis 0
STACKED = ("layers", "encoder")


def param_tree(model: Model, values: Optional[Mapping[str, Tensor]] = None
               ) -> dict:
    """The model's parameters, or `values` (tensors keyed and shaped like
    them, e.g. gradients or optimizer moments), in the reference's tree
    layout: nested dicts keyed by the dotted name's parts, with every leaf
    of "layers" (periods) and "encoder" (encoder layers) stacked on a new
    axis 0. The inverse of `interop.model_params_from_numpy`."""
    if values is None:
        values = {n: p.detach() for n, p in model.named_parameters()}
    tree: dict = {}
    stacks: Dict[Tuple[str, ...], List[Tuple[int, Tensor]]] = {}
    for name, t in values.items():
        parts = name.split(".")
        if parts[0] in STACKED:
            stacks.setdefault((parts[0], *parts[2:]), []).append(
                (int(parts[1]), t))
        else:
            _put(tree, parts, t)
    for path, items in stacks.items():
        _put(tree, path, torch.stack([t for _, t in sorted(
            items, key=lambda it: it[0])]))
    return tree


def _put(tree: dict, path, leaf):
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = leaf


@torch.no_grad()
def prepare_cross_cache(model: Model, cfg: ModelConfig, cache: Cache,
                        frame_embeds: Tensor) -> Tuple[Cache, Tensor]:
    """Run the encoder once and fill every `attn_cross` layer's CrossKV
    entry of `cache` (from `init_cache` with `cross_kv_cache`), in place.
    Returns (cache, enc_out). The admission step that makes each decode
    step encoder-free: prefill and serve_step then take no frames."""
    if not cfg.cross_kv_cache:
        raise ValueError(f"{cfg.name}: prepare_cross_cache needs "
                         "cross_kv_cache=True")
    enc_out = _encoder_forward(model, cfg, frame_embeds)
    for period, c in zip(model.layers, cache):
        for nm, p in period.items():
            if nm.split("_", 1)[1] == "attn_cross":
                xkv = attn_lib.make_cross_kv(p.xattn, enc_out)
                c[nm]["cross"].xk.copy_(xkv.xk)
                c[nm]["cross"].xv.copy_(xkv.xv)
    return cache, enc_out


@torch.no_grad()
def prefill(model: Model, cfg: ModelConfig, batch: Dict[str, Tensor],
            cache: Cache) -> Tuple[Tensor, Cache]:
    """Block prefill: one full-sequence forward that also fills the decode
    cache (attention K/V slots, MLA latents, Mamba conv tails and states,
    RWKV states). Returns (logits, cache). Continue with
    serve_step(..., pos=the prefilled length, patches included). Any
    prompt length: the mamba scan runs over the whole sequence, and the
    rwkv scan pads its last chunk with state-preserving lanes."""
    logits, _, new_cache = model_forward(model, cfg, batch, mode="prefill",
                                         cache=cache)
    return logits, new_cache


@torch.no_grad()
def serve_step(model: Model, cfg: ModelConfig, cache: Cache, token: Tensor,
               pos: Union[int, Tensor],
               extras: Optional[Dict[str, Tensor]] = None
               ) -> Tuple[Tensor, Cache]:
    """One decode step: token (B,) at absolute position `pos` ->
    (logits (B, V), new cache). `extras` carries the encoder's input
    ("frame_embeds") or output ("enc_out") for encoder-decoder models."""
    batch = {"tokens": token[:, None]}
    if extras:
        batch.update(extras)
    logits, _, new_cache = model_forward(model, cfg, batch, mode="decode",
                                         cache=cache, pos=pos)
    return logits[:, 0], new_cache
