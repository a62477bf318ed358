"""InternLM2-20B — dense GQA decoder. [arXiv:2403.17297]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", arch_type="dense",
    n_layers=48, d_model=6144, n_heads=48, kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92544,
    block_pattern=("attn",),
    rope_theta=1e6,
    source="arXiv:2403.17297",
)
