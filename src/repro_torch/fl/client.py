"""Local client training (the "R_l local iterations" of the paper's FL model).

Port of `repro/fl/client.py`. A client trains on its own shard for
`local_iters` full-batch gradient steps (the paper's local iteration uses
all D_n samples, §III), at the video-frame resolution the allocator chose
for it. Gradients come from `torch.autograd`; every step makes new
parameter tensors, so no gradient state is shared between clients.

Training runs in PyTorch's deterministic-algorithms mode
(`deterministic_algorithms`, restored on exit): on the card the
convolutions' backward may otherwise pick a weight-gradient algorithm that
sums in a varying order, and two runs on the same inputs then differ in
their bits (seen after other work had run in the same process). An
operation with no deterministic implementation raises in that mode.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from ..models.cnn import Params, xent_loss

Tensor = torch.Tensor


@contextlib.contextmanager
def deterministic_algorithms():
    """`torch.use_deterministic_algorithms(True)` for the scope, so the
    convolutions take deterministic algorithms and an operation without
    one raises, without the mode's NaN fill of every new tensor (no op
    here reads memory it has not written; the fill is a launch per
    allocation). The caller's settings come back on exit."""
    det = torch.utils.deterministic
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]


def _leaves(params: Params):
    return [(layer, leaf, x) for layer, d in params.items()
            for leaf, x in d.items()]


def local_train(params: Params, images: Tensor, labels: Tensor,
                lr: float, local_iters: int) -> Tuple[Params, Tensor]:
    """Full-batch SGD for `local_iters` steps on one client's rendered data.

    images: (D_n, s, s, 1) already rendered at the allocated resolution.
    Returns (new_params, loss): the loss is the one the last step computed
    before its update (0.0 when local_iters is 0), a 0-d tensor on the
    device.
    """
    flat = _leaves(params)
    xs = [x.detach() for _, _, x in flat]
    loss = torch.zeros((), dtype=xs[0].dtype, device=xs[0].device)
    with deterministic_algorithms():
        for _ in range(local_iters):
            xs = [x.requires_grad_(True) for x in xs]
            p = {}
            for (layer, leaf, _), x in zip(flat, xs):
                p.setdefault(layer, {})[leaf] = x
            with torch.enable_grad():
                loss = xent_loss(p, images, labels)
                grads = torch.autograd.grad(loss, xs)
            with torch.no_grad():
                xs = [x - lr * g for x, g in zip(xs, grads)]
            loss = loss.detach()
    out: Params = {}
    for (layer, leaf, _), x in zip(flat, xs):
        out.setdefault(layer, {})[leaf] = x
    return out, loss


def client_delta(params_before: Params, params_after: Params) -> Params:
    return {layer: {leaf: params_after[layer][leaf] - x
                    for leaf, x in d.items()}
            for layer, d in params_before.items()}
