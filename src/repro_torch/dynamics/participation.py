"""Participation models: stragglers, dropouts, and the async staleness queue.

Port of `repro/dynamics/participation.py`. Every function works on a
leading cell axis: per-device tensors are (C, N), the staleness queue is a
(C, K) ring whose slot j holds the aggregate mass arriving j+1 rounds from
now.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def staleness_of(t_dev: Tensor, deadline: Tensor,
                 max_staleness: int) -> Tensor:
    """Rounds of lateness per device: an update whose realized round time
    t_n lands in (k * deadline, (k+1) * deadline] arrives k rounds late.
    On-time devices (t_n <= deadline) get 0; lateness clips to
    `max_staleness`. `deadline` broadcasts against `t_dev` ((C, 1) against
    (C, N))."""
    d = torch.clamp_min(torch.as_tensor(deadline, dtype=t_dev.dtype,
                                        device=t_dev.device),
                        torch.finfo(t_dev.dtype).tiny)
    k = torch.ceil(t_dev / d) - 1.0
    return torch.clamp(k, 0, max_staleness).to(torch.int32)


def queue_step(queue_w: Tensor, queue_u: Tensor, push_idx: Tensor,
               push_w: Tensor, push_u: Tensor
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One round of the staleness queue.

    Pops slot 0 (mass arriving this round), shifts the ring left, and adds
    the newly late mass: a device k rounds late this round is pushed at
    index k-1 of the shifted queue (it arrives at round r+k, which is k-1
    rounds after round r+1).

    queue_w / queue_u: (C, K) aggregate FedAvg weight / utility mass.
    push_idx: (C, N) int in [0, K); push_w / push_u: (C, N) masses (0 where
    a device is not late). Returns (queue_w', queue_u', popped_w,
    popped_u), the popped masses (C,).
    """
    pop_w, pop_u = queue_w[:, 0], queue_u[:, 0]
    zero = torch.zeros_like(queue_w[:, :1])
    idx = push_idx.long()
    qw = torch.cat([queue_w[:, 1:], zero], -1).scatter_add_(-1, idx, push_w)
    qu = torch.cat([queue_u[:, 1:], zero], -1).scatter_add_(-1, idx, push_u)
    return qw, qu, pop_w, pop_u
