"""Granite 34B Code — llama-arch dense decoder with MQA (kv=1).
[arXiv:2405.04324]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", arch_type="dense",
    n_layers=88, d_model=6144, n_heads=48, kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
    block_pattern=("attn",),
    source="arXiv:2405.04324",
)
