"""DBRX (132B total) — fine-grained 16-expert top-4 MoE.
[hf:databricks/dbrx-base]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", arch_type="moe",
    n_layers=40, d_model=6144, n_heads=48, kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    n_experts=16, top_k=4,
    block_pattern=("attn_moe",),
    rope_theta=5e5,
    source="hf:databricks/dbrx-base",
)
