"""Common transformer building blocks.

Port of `repro/models/layers.py`. Parameters live in `nn.Module`s whose
attribute names are the reference's dict leaves (`scale`, `wi`, `wg`,
`wo`, `tokens`, `w`), so a JAX parameter tree maps onto them name for name
(`interop.model_params_from_numpy`). Every init draws from an explicit
`torch.Generator` on the target device with the reference's distribution
and scale, one tensor at a time; on "meta" (`MetaGenerator`) nothing is
drawn and every parameter is an empty meta tensor of the same name, shape
and dtype. The reference's `shard(...)` constraints stand at its places
(`sharding.partition.shard`): without active rules each is one check.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..sharding.partition import shard

Tensor = torch.Tensor


class MetaGenerator:
    """Stands for a `torch.Generator` in an abstract build (PyTorch has no
    generator on "meta"): `normal` draws nothing from it."""
    device = torch.device("meta")


def normal(gen: torch.Generator, shape: Sequence[int], sd: float,
           dtype: torch.dtype) -> nn.Parameter:
    """N(0, sd^2) drawn in float32 on the generator's device, cast to
    `dtype` (the reference's `(jax.random.normal(k, shape) * sd).astype`);
    an empty meta tensor from a `MetaGenerator`."""
    if gen.device.type == "meta":
        return nn.Parameter(torch.empty(tuple(shape), dtype=dtype,
                                        device="meta"), requires_grad=False)
    x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return nn.Parameter(x.mul_(sd).to(dtype), requires_grad=False)


def const(shape: Sequence[int], value: float, device,
          dtype: torch.dtype = torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.full(tuple(shape), value, device=device,
                                   dtype=dtype), requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.scale = const((d,), 1.0, device)


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None, None].float() * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, d_ff: int,
                 dtype: torch.dtype):
        super().__init__()
        sd_in = (2.0 / (d_model + d_ff)) ** 0.5
        self.wi = normal(gen, (d_model, d_ff), sd_in, dtype)
        self.wg = normal(gen, (d_model, d_ff), sd_in, dtype)
        self.wo = normal(gen, (d_ff, d_model), sd_in, dtype)


def apply_mlp(p: MLP, x: Tensor) -> Tensor:
    h = torch.matmul(x, p.wi)
    g = torch.matmul(x, p.wg)
    h = shard(torch.nn.functional.silu(g) * h, "batch", "seq", "mlp")
    return torch.matmul(h, p.wo)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    def __init__(self, gen: torch.Generator, vocab: int, d_model: int,
                 dtype: torch.dtype):
        super().__init__()
        self.tokens = normal(gen, (vocab, d_model), 0.02, dtype)


class LMHead(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, vocab: int,
                 dtype: torch.dtype):
        super().__init__()
        self.w = normal(gen, (d_model, vocab), 0.02, dtype)


def embed_tokens(embed: Embed, tokens: Tensor) -> Tensor:
    return embed.tokens[tokens]


def lm_logits(embed: Embed, head: Optional[LMHead], x: Tensor) -> Tensor:
    """Logits in float32: the tied embedding unless an untied head exists."""
    w = head.w if head is not None else embed.tokens.t()
    return shard(torch.matmul(x, w).float(), "batch", "seq", "vocab")


def softmax_xent(logits: Tensor, labels: Tensor,
                 mask: Optional[Tensor] = None) -> Tensor:
    """Mean next-token cross entropy; logits (..., V) float32, labels
    (...) int64. With `mask`, the mean over the masked positions: the sum
    of -log p there over max(sum(mask), 1)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, labels[..., None])[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.to(ll.dtype)
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
