"""Step functions (prefill / serve) shared by the serving entry point.

Port of the serving half of `repro/launch/steps.py`; training steps are not
ported (ROADMAP.md, Queue 1 item 12). PyTorch runs eagerly, so the steps
are plain closures over the config where the reference's are jitted.
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from ..models.transformer import model_forward, serve_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model, batch):
        logits, _, _ = model_forward(model, cfg, batch, mode="prefill")
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def _serve(model, cache, token, pos, extras=None):
        return serve_step(model, cfg, cache, token, pos, extras)

    return _serve
