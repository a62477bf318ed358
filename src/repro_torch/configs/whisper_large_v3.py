"""Whisper large-v3 — encoder-decoder audio model; the mel+conv frontend is a
STUB per the assignment: input_specs provides precomputed 1500-frame
embeddings. [arXiv:2212.04356]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", arch_type="audio",
    n_layers=32, d_model=1280, n_heads=20, kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866,
    block_pattern=("attn_cross",),   # decoder: self-attn + cross-attn + mlp
    encoder_layers=32, encoder_ctx=1500,
    source="arXiv:2212.04356",
)
