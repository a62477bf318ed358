"""Input specs for every (architecture x input-shape) pair: empty "meta"
tensors of the inputs' shapes and dtypes, with no storage.

Port of `repro/launch/specs.py` (there `jax.ShapeDtypeStruct`s).

INPUT SHAPES:
    train_4k     seq=4096    global_batch=256   (training)
    prefill_32k  seq=32768   global_batch=32    (inference prefill)
    decode_32k   seq=32768   global_batch=128   (decode: 1 token + 32k cache)
    long_500k    seq=524288  global_batch=1     (long-context decode)

Decode shapes run `serve_step` (one token + cache); `long_500k` needs
sub-quadratic attention: dense archs run it with the sliding-window
variant (a config flag), whisper skips it. Tokens are int32, as the
port's data pipeline gives them (`data/pipeline.py`); embeddings bf16.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig

SHAPES: Dict[str, dict] = {
    "train_4k":    dict(kind="train",   seq=4096,    batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768,   batch=32),
    "decode_32k":  dict(kind="decode",  seq=32768,   batch=128),
    "long_500k":   dict(kind="decode",  seq=524288,  batch=1),
}

LONG_WINDOW = 4096          # sliding window used for the long_500k variant


def adapt_config(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """Shape-specific config adjustments: long_500k forces a
    sliding-window attention variant on dense archs."""
    if shape_name == "long_500k":
        if cfg.arch_type == "audio":
            raise ValueError(
                "whisper-large-v3 skips long_500k: enc-dec full attention has "
                "no meaningful 500k sliding-window decode")
        if cfg.attention != "none" and cfg.sliding_window is None:
            cfg = cfg.replace(sliding_window=LONG_WINDOW)
    return cfg


def supported(cfg: ModelConfig, shape_name: str) -> bool:
    return not (shape_name == "long_500k" and cfg.arch_type == "audio")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, torch.Tensor]:
    """Meta tensors for the model inputs of this shape."""
    sh = SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]
    if sh["kind"] in ("train", "prefill"):
        text = S
        out: Dict[str, torch.Tensor] = {}
        if cfg.n_patches:
            text = S - cfg.n_patches
            out["patch_embeds"] = _meta((B, cfg.n_patches, cfg.d_model),
                                        torch.bfloat16)
        if cfg.encoder_layers:
            out["frame_embeds"] = _meta((B, cfg.encoder_ctx, cfg.d_model),
                                        torch.bfloat16)
        out["tokens"] = _meta((B, text), torch.int32)
        return out
    # decode: one token + absolute position (+ encoder frames for enc-dec)
    out = {"token": _meta((B,), torch.int32), "pos": _meta((), torch.int32)}
    # with cross_kv_cache the encoder ran once at admission and the cross
    # K/V live in the cache: the step takes no frames
    if cfg.encoder_layers and not cfg.cross_kv_cache:
        out["frame_embeds"] = _meta((B, cfg.encoder_ctx, cfg.d_model),
                                    torch.bfloat16)
    return out


def decode_cache_len(cfg: ModelConfig, shape_name: str) -> int:
    S = SHAPES[shape_name]["seq"]
    return min(cfg.sliding_window, S) if cfg.sliding_window else S
