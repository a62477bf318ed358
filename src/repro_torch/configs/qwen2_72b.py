"""Qwen2-72B — dense GQA decoder with QKV bias. [arXiv:2407.10671]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", arch_type="dense",
    n_layers=80, d_model=8192, n_heads=64, kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064,
    qkv_bias=True,
    block_pattern=("attn",),
    rope_theta=1e6,
    tied_embeddings=False,
    source="arXiv:2407.10671",
)
