"""Assigned-architecture configs (--arch <id>). Every config cites its source.

`get_config(name)` returns the full production config; `.reduced()` gives the
CPU smoke-test variant (2 layers-ish, d_model<=128, <=4 experts).
"""
from __future__ import annotations

from typing import Dict

from .base import ModelConfig
from .mixtral_8x7b import CONFIG as mixtral_8x7b
from .qwen2_72b import CONFIG as qwen2_72b
from .minicpm3_4b import CONFIG as minicpm3_4b
from .rwkv6_1b6 import CONFIG as rwkv6_1b6
from .whisper_large_v3 import CONFIG as whisper_large_v3
from .jamba_1_5_large import CONFIG as jamba_1_5_large
from .dbrx_132b import CONFIG as dbrx_132b
from .llava_next_34b import CONFIG as llava_next_34b
from .granite_34b import CONFIG as granite_34b
from .internlm2_20b import CONFIG as internlm2_20b
from .flmar_cnn import CONFIG as flmar_cnn

ARCHS: Dict[str, ModelConfig] = {
    "mixtral-8x7b": mixtral_8x7b,
    "qwen2-72b": qwen2_72b,
    "minicpm3-4b": minicpm3_4b,
    "rwkv6-1.6b": rwkv6_1b6,
    "whisper-large-v3": whisper_large_v3,
    "jamba-1.5-large-398b": jamba_1_5_large,
    "dbrx-132b": dbrx_132b,
    "llava-next-34b": llava_next_34b,
    "granite-34b": granite_34b,
    "internlm2-20b": internlm2_20b,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ModelConfig", "ARCHS", "get_config", "flmar_cnn"]
