"""Step functions (train / prefill / serve) shared by the entry points.

Port of `repro/launch/steps.py`. PyTorch runs eagerly, so the steps are
plain closures over the config where the reference's are jitted.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..models.transformer import lm_loss, model_forward, serve_step
from ..optim import AdamW, clip_scale, global_norm


def make_train_step(cfg: ModelConfig, optimizer: Optional[AdamW] = None,
                    clip: float = 1.0, accum_steps: int = 1):
    """Returns (train_step, optimizer). train_step(model, opt_state, batch,
    grads_out=None) -> (model, new opt_state, {"loss", "grad_norm"}): the
    loss's gradients (autograd), their global norm, the clip scale folded
    into the optimizer's float32 update, the parameters updated in place.
    It makes every parameter trainable and reads nothing to the host.

    accum_steps > 1 splits the batch into that many microbatches on axis
    0, one forward and backward each (a batch whose axis 0 is not a
    multiple of accum_steps raises ValueError, as the reference's reshape
    does); their gradients are summed in
    float32 buffers and divided by accum_steps, as the reference's g_acc
    (accumulating in `.grad` would add in the parameters' dtype). The loss
    is the microbatches' mean. `grads_out`, if a dict, receives each
    parameter's gradient by name (after accumulation, before clipping)."""
    opt = optimizer or AdamW(lr=3e-4)

    def grads_of(model, batch, leaves):
        loss = lm_loss(model, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    def train_step(model, opt_state, batch: Dict[str, torch.Tensor],
                   grads_out: Optional[dict] = None):
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        leaves = list(params.values())
        if accum_steps == 1:
            loss, grads = grads_of(model, batch, leaves)
        else:
            for k, v in batch.items():
                if v.shape[0] % accum_steps:
                    raise ValueError(
                        f"make_train_step: batch[{k!r}] has {v.shape[0]} "
                        f"rows, not a multiple of accum_steps={accum_steps}")
            n = next(iter(batch.values())).shape[0] // accum_steps
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(accum_steps):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, gs = grads_of(model, mb, leaves)
                for acc, g in zip(grads, gs):
                    acc.add_(g.float())
                loss = loss + l
            loss = loss / accum_steps
            for g in grads:
                g.div_(accum_steps)
        grads = dict(zip(params, grads))
        if grads_out is not None:
            grads_out.update(grads)
        gnorm = global_norm(grads)
        opt_state = opt.update(grads, opt_state, params,
                               grad_scale=clip_scale(gnorm, clip))
        return model, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step, opt


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model, batch):
        logits, _, _ = model_forward(model, cfg, batch, mode="prefill")
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def _serve(model, cache, token, pos, extras=None):
        return serve_step(model, cfg, cache, token, pos, extras)

    return _serve
