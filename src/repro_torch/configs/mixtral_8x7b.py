"""Mixtral 8x7B — 8-expert top-2 MoE with sliding-window attention.
[arXiv:2401.04088]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", arch_type="moe",
    n_layers=32, d_model=4096, n_heads=32, kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    n_experts=8, top_k=2,
    block_pattern=("attn_moe",),
    sliding_window=4096,           # native SWA -> ring KV cache, long_500k OK
    rope_theta=1e6,
    source="arXiv:2401.04088",
)
