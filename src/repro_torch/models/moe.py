"""Mixture-of-Experts layer: top-k router + capacity-based dispatch
(GShard/Switch style).

Port of `repro/models/moe.py`. Router: softmax over experts in float32,
top-k, gates renormalised over the top k; Switch-style load-balance aux
loss (mean(probs) . mean(assignment) * E). Dispatch keeps the reference's
capacity exactly: C = max(int(k S capacity_factor / E), 1) slots per expert
and batch row, filled in sequence order; an assignment past the capacity
is dropped. Tokens are gathered into (B, E, C, D) slots, the experts' SwiGLU
runs as batched matrix products over E (library matmuls: the reference
leaves them to XLA, outside any Pallas kernel), and each token gathers its
own k expert outputs back and sums them in top-k order. With k = 2 that sum
equals the reference's scatter-add onto zeros bit for bit, and every run
gives the same bits (no atomics).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..sharding.partition import shard
from .layers import normal

Tensor = torch.Tensor


def _normal_stack(gen: torch.Generator, shape: Sequence[int], sd: float,
                  dtype: torch.dtype) -> nn.Parameter:
    """N(0, sd^2) of `shape`, drawn one leading slice at a time, so the
    float32 draw of one expert is the largest transient."""
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    for e in range(shape[0] if gen.device.type != "meta" else 0):
        out[e] = normal(gen, shape[1:], sd, dtype)
    return nn.Parameter(out, requires_grad=False)


class MoE(nn.Module):
    """Router and expert weights, named as the reference's `init_moe`
    leaves: router (d, E) float32, wi / wg (E, d, f), wo (E, f, d)."""

    def __init__(self, gen: torch.Generator, d_model: int, d_ff: int,
                 n_experts: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        sd = (2.0 / (d_model + d_ff)) ** 0.5
        self.router = normal(gen, (d_model, n_experts), 0.02, torch.float32)
        self.wi = _normal_stack(gen, (n_experts, d_model, d_ff), sd, dtype)
        self.wg = _normal_stack(gen, (n_experts, d_model, d_ff), sd, dtype)
        self.wo = _normal_stack(gen, (n_experts, d_ff, d_model), sd, dtype)


def _top_k_gates(logits: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """logits (..., E) -> (gates (..., E) sparse and renormalised, the top-k
    expert indices (..., k), aux loss)."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    top_vals, top_idx = torch.topk(probs, k, dim=-1)
    gates = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # Switch-style load-balance loss
    me = probs.reshape(-1, E).mean(0)
    ce = (gates > 0).float().reshape(-1, E).mean(0)
    return gates, top_idx, (me * ce).sum() * E


def apply_moe(p: MoE, x: Tensor, top_k: int,
              capacity_factor: float = 1.25) -> Tuple[Tensor, Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss float32)."""
    B, S, D = x.shape
    E = p.router.shape[-1]
    cap = max(int(top_k * S * capacity_factor / E), 1)   # per batch row

    logits = torch.matmul(x.float(), p.router)
    gates, top_idx, aux = _top_k_gates(logits, top_k)    # (B, S, E)

    assigned = gates > 0
    pos_in_e = assigned.int().cumsum(1) - 1              # (B, S, E)
    keep = assigned & (pos_in_e < cap)
    slot = torch.where(keep, pos_in_e, cap)              # cap: dropped

    # the token of each slot (cap + 1 columns: the last takes the drops)
    s_ix = torch.arange(S, device=x.device)[None, :, None].expand(B, S, E)
    sidx = slot.new_zeros((B, E, cap + 1), dtype=torch.long)
    sidx.scatter_(2, slot.transpose(1, 2), s_ix.transpose(1, 2))
    sidx = sidx[..., :cap]                               # (B, E, C)
    filled = torch.arange(cap, device=x.device) \
        < keep.sum(1)[..., None]                         # slots fill in order

    xe = x[torch.arange(B, device=x.device)[:, None, None], sidx]
    xe = torch.where(filled[..., None], xe, 0)           # (B, E, C, D)
    xe = shard(xe, "batch", "experts", None, None)
    xe = xe.transpose(0, 1).reshape(E, B * cap, D)
    h = torch.bmm(xe, p.wi)
    g = torch.bmm(xe, p.wg)
    ye = torch.bmm(torch.nn.functional.silu(g) * h, p.wo)  # (E, B C, D)
    ye = ye.reshape(E, B, cap, D).transpose(0, 1)        # (B, E, C, D)
    ye = shard(ye, "batch", "experts", None, None)

    # combine: each token gathers its k outputs (a zero row for a dropped
    # assignment), weighted by its gate in x's dtype, summed in top-k order
    ye = torch.cat([ye, ye.new_zeros((B, E, 1, D))], dim=2)
    slot_k = slot.gather(2, top_idx)                     # (B, S, k)
    gate_k = gates.gather(2, top_idx).to(x.dtype)
    b_ix = torch.arange(B, device=x.device)[:, None]
    out = ye[b_ix, top_idx[..., 0], slot_k[..., 0]] * gate_k[..., :1]
    for j in range(1, top_k):
        out = out + ye[b_ix, top_idx[..., j], slot_k[..., j]] \
            * gate_k[..., j:j + 1]
    return out, aux
