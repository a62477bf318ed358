"""AdamW + SGD + LR schedules.

Port of `repro/optim/adamw.py`. Parameters, gradients and moments are
mappings of names to tensors (`dict(model.named_parameters())`; the
reference's tree layout comes from `models.transformer.param_tree`). The
optimizer states are float32 whatever the parameter's dtype, the update is
computed in float32 in the reference's order and cast back to the
parameter's dtype (`torch.optim.AdamW` keeps bf16 state for bf16
parameters, a different result). `update` writes the new parameters and
moments in place and returns the new state; the step is a 0-d int32
tensor on the parameters' device, so an update reads nothing to the host.

`clip_by_global_norm` returns the clipped gradients as the reference does
(a bf16 gradient times the float32 scale is float32). The train step
instead passes the scale to `update(grad_scale=...)`, which multiplies each
float32 gradient by it: the same numbers, with no float32 copy of all the
gradients.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Union

import torch

Tensor = torch.Tensor
Tensors = Mapping[str, Tensor]
Schedule = Callable[[Tensor], Tensor]


class AdamWState(NamedTuple):
    step: Tensor                      # 0-d int32
    mu: Optional[Dict[str, Tensor]]   # float32, named as the parameters
    nu: Optional[Dict[str, Tensor]]


def _zeros(params: Tensors) -> Dict[str, Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _step0(params: Tensors) -> Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


def _lr(lr: Union[Schedule, float], step: Tensor):
    return lr(step) if callable(lr) else lr


def _grad32(g: Tensor, scale: Optional[Tensor]) -> Tensor:
    g = g.float()
    return g if scale is None else g * scale


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Schedule, float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: Tensors) -> AdamWState:
        return AdamWState(step=_step0(params), mu=_zeros(params),
                          nu=_zeros(params))

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdamWState, params: Tensors,
               grad_scale: Optional[Tensor] = None) -> AdamWState:
        """One step: each parameter and its moments are updated in place
        (the gradient times `grad_scale`, if given, in float32)."""
        step = state.step + 1
        lr = _lr(self.lr, step)
        b1, b2 = self.b1, self.b2
        sf = step.float()
        c1 = 1 - torch.pow(b1, sf)
        c2 = 1 - torch.pow(b2, sf)
        for name, p in params.items():
            g = _grad32(grads[name], grad_scale)
            m, v = state.mu[name], state.nu[name]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p32 = p.float()
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps) \
                + self.weight_decay * p32
            p.copy_((p32 - lr * delta).to(p.dtype))
        return AdamWState(step=step, mu=state.mu, nu=state.nu)


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: Union[Schedule, float] = 1e-2
    momentum: float = 0.0

    def init(self, params: Tensors) -> AdamWState:
        mu = _zeros(params) if self.momentum != 0.0 else None
        return AdamWState(step=_step0(params), mu=mu, nu=None)

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdamWState, params: Tensors,
               grad_scale: Optional[Tensor] = None) -> AdamWState:
        step = state.step + 1
        lr = _lr(self.lr, step)
        for name, p in params.items():
            g = _grad32(grads[name], grad_scale)
            if self.momentum != 0.0:
                g = state.mu[name].mul_(self.momentum).add_(g)
            p.copy_((p.float() - lr * g).to(p.dtype))
        return AdamWState(step=step, mu=state.mu, nu=None)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Schedule:
    def lr(step: Tensor) -> Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = base_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return lr


def linear_schedule(base_lr: float, warmup: int, total: int) -> Schedule:
    def lr(step: Tensor) -> Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        return torch.where(step < warmup, warm, base_lr * (1 - frac))
    return lr


def global_norm(tree: Tensors) -> Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree.values()))


def clip_scale(norm: Tensor, max_norm: float) -> Tensor:
    """min(1, max_norm / max(norm, 1e-9)): the factor that clips a tree of
    global norm `norm` to `max_norm`."""
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)


def clip_by_global_norm(tree: Tensors, max_norm: float):
    """(the leaves times `clip_scale`, in float32 for a 16-bit leaf as in
    the reference, the global norm)."""
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return {n: t * scale for n, t in tree.items()}, norm
