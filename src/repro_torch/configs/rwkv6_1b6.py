"""RWKV6 "Finch" 1.6B — attention-free, data-dependent decay WKV.
[arXiv:2404.05892]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", arch_type="ssm",
    n_layers=24, d_model=2048, n_heads=32, kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65536,
    attention="none",
    block_pattern=("rwkv",),
    source="arXiv:2404.05892",
)
