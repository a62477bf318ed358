"""MiniCPM3-4B — dense decoder with Multi-head Latent Attention (MLA).
[hf:openbmb/MiniCPM3-4B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", arch_type="dense",
    n_layers=62, d_model=2560, n_heads=40, kv_heads=40, head_dim=64,
    d_ff=6400, vocab_size=73448,
    attention="mla",
    q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    block_pattern=("attn",),
    source="hf:openbmb/MiniCPM3-4B",
)
