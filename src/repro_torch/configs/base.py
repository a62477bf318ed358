"""ModelConfig: one dataclass describing every architecture in the zoo.

Port of `repro/configs/base.py`: the same fields, defaults and `reduced()`;
`torch_dtype` takes the place of the reference's `np_dtype`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer pattern: kinds repeated over n_layers // len(pattern) periods.
    # kinds: attn, attn_moe, attn_cross (dec w/ cross-attn), enc_attn,
    #        mamba, mamba_moe, rwkv
    block_pattern: Tuple[str, ...] = ("attn",)

    # attention
    attention: str = "gqa"         # gqa | mla | none
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # native SWA window (tokens)
    rope_theta: float = 1e4

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM
    d_state: int = 16
    d_conv: int = 4
    ssm_chunk: int = 256
    rwkv_chunk: int = 64

    # encoder-decoder (whisper): encoder layers use 'enc_attn'
    encoder_layers: int = 0
    encoder_ctx: int = 0           # e.g. 1500 audio frames

    # VLM: prefix patch embeddings (anyres tiling handled by the frontend stub)
    n_patches: int = 0

    # decode-path optimization (EXPERIMENTS.md §Perf): cache the encoder
    # output and per-layer cross-attention K/V instead of recomputing the
    # encoder every decode step
    cross_kv_cache: bool = False
    # int8 KV cache (per-slot/head scales): halves decode HBM traffic (§Perf)
    kv_cache_int8: bool = False

    norm_eps: float = 1e-5
    tied_embeddings: bool = True
    dtype: str = "bfloat16"
    remat: bool = True             # checkpoint each scanned period in training
    # 'full' recomputes everything in bwd; 'dots' saves matmul outputs
    # (less recompute, more memory) — §Perf hillclimb knob
    remat_policy: str = "full"

    # citation for the config numbers
    source: str = ""

    @property
    def torch_dtype(self) -> torch.dtype:
        return dict(bfloat16=torch.bfloat16, float32=torch.float32)[self.dtype]

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.block_pattern) == 0, \
            f"{self.name}: n_layers {self.n_layers} not divisible by pattern {len(self.block_pattern)}"
        return self.n_layers // len(self.block_pattern)

    @property
    def d_inner(self) -> int:      # mamba inner width
        return 2 * self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (spec: <=2 periods,
        d_model<=512, <=4 experts)."""
        pat = self.block_pattern
        d_model = min(self.d_model, 128)
        n_heads = min(self.n_heads, 4)
        head_dim = d_model // n_heads
        kv = min(self.kv_heads, n_heads)
        kv = max(1, n_heads // max(1, self.n_heads // max(self.kv_heads, 1)))
        return self.replace(
            n_layers=len(pat) * (2 if len(pat) == 1 else 1),
            d_model=d_model, n_heads=n_heads,
            kv_heads=min(kv, n_heads), head_dim=head_dim,
            d_ff=min(self.d_ff, 256), vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            q_lora_rank=min(self.q_lora_rank, 32) if self.q_lora_rank else 0,
            kv_lora_rank=min(self.kv_lora_rank, 16) if self.kv_lora_rank else 0,
            qk_nope_dim=min(self.qk_nope_dim, 16) if self.qk_nope_dim else 0,
            qk_rope_dim=min(self.qk_rope_dim, 8) if self.qk_rope_dim else 0,
            v_head_dim=min(self.v_head_dim, 32) if self.v_head_dim else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            encoder_ctx=min(self.encoder_ctx, 32) if self.encoder_ctx else 0,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            ssm_chunk=32, rwkv_chunk=16, remat=False,
        )
