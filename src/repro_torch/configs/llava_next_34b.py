"""LLaVA-NeXT 34B — VLM: language decoder consuming anyres patch embeddings;
the ViT/SigLIP vision tower + projector is a STUB per the assignment
(input_specs provides projected patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf scaled to the 34B card]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", arch_type="vlm",
    n_layers=60, d_model=7168, n_heads=56, kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    block_pattern=("attn",),
    n_patches=2880,                 # anyres: 4 tiles + base, 576 each
    rope_theta=5e6,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
