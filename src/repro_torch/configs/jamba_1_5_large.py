"""Jamba-1.5-Large (398B total) — hybrid Mamba+attention 1:7 interleave with
16-expert top-2 MoE on alternating layers. [arXiv:2403.19887]

Period of 8 layers (9 periods x 8 = 72): the attention layer sits mid-period;
MoE on every other layer, mirroring the published block structure."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", arch_type="hybrid",
    n_layers=72, d_model=8192, n_heads=64, kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    n_experts=16, top_k=2,
    block_pattern=("mamba", "mamba_moe", "mamba", "mamba_moe",
                   "attn", "mamba_moe", "mamba", "mamba_moe"),
    d_state=16, d_conv=4,
    source="arXiv:2403.19887",
)
