"""Per-architecture cost models: the bridge between the paper's c_n
("CPU cycles per standard sample", eq. 4) and the model zoo.

Port of `repro/core/costmodel.py`; `arch_system` draws through the port's
`core.channel.make_system` (a torch.Generator or an integer seed, on
CUDA unless the caller names another device).

The paper derives the O(s^2) scaling of per-sample compute from the CNN time
complexity (eqs. 5-6). For the assigned architectures the same role is played
by FLOPs-per-sample of the local workload; `cycles_per_standard_sample`
converts analytic forward+backward FLOPs into "cycles" at a nominal
device throughput so the allocator sees each architecture through the same
c_n interface.

`token_budget(s)` generalizes the resolution knob: the paper's square frame of
s x s pixels maps to a token count proportional to s^2 (ViT-style patching for
VLM frames, mel-frame count for audio, sequence length for LMs), preserving
the paper's quadratic cost-vs-resolution hook.
"""
from __future__ import annotations

import dataclasses

import torch

FLOPS_PER_CYCLE = 8.0      # nominal client device: flops retired per "cycle"
PATCH = 16                 # ViT-style patch edge for frame -> token conversion


def dense_layer_flops(d_model: int, d_ff: int, n_heads: int, kv_heads: int,
                      head_dim: int, seq: int) -> float:
    """Analytic forward FLOPs for one transformer layer at sequence length seq."""
    qkv = 2 * seq * d_model * (n_heads + 2 * kv_heads) * head_dim
    attn = 2 * 2 * seq * seq * n_heads * head_dim          # scores + values
    out = 2 * seq * n_heads * head_dim * d_model
    mlp = 2 * 3 * seq * d_model * d_ff                     # gated MLP
    return float(qkv + attn + out + mlp)


@dataclasses.dataclass(frozen=True)
class ArchCost:
    name: str
    flops_per_token: float      # fwd flops per token (active params path)
    params_active: float
    params_total: float

    def flops_per_sample(self, tokens_per_sample: int, training: bool = True) -> float:
        mult = 3.0 if training else 1.0  # bwd ~ 2x fwd
        return self.flops_per_token * tokens_per_sample * mult

    def cycles_per_standard_sample(self, tokens_per_sample: int,
                                   training: bool = True) -> float:
        """The paper's c_n for this architecture's local workload."""
        return self.flops_per_sample(tokens_per_sample, training) / FLOPS_PER_CYCLE


def tokens_for_resolution(s_pixels: float, patch: int = PATCH) -> int:
    """Frame of s x s pixels -> token budget (O(s^2), matching eq. 7)."""
    return max(int(s_pixels / patch) ** 2, 1)


def arch_system(gen, arch_name: str, n_devices: int = 20,
                device_flops_per_cycle: float = 8192.0,
                samples_per_device: int = 4, local_iters: int = 1, *,
                device=None, dtype: torch.dtype = torch.float32,
                **overrides):
    """Build a SystemParams whose c_n comes from an assigned architecture's
    cost model: the paper's 'CPU cycles per
    standard sample' becomes FLOPs-per-sample of the local training workload
    at the standard frame's token budget, at a device NPU throughput of
    `device_flops_per_cycle` flops/cycle (default: 8 TFLOP/s @ 1 GHz).

    The allocator then trades the architecture's real compute intensity
    against channel conditions — heavier local models push their devices
    toward lower frame resolutions at equal objective weights."""
    from ..configs import get_config

    from .channel import make_system
    from .types import DEFAULTS

    cost = from_config(get_config(arch_name))
    std_tokens = tokens_for_resolution(DEFAULTS["s_standard"])
    c = cost.flops_per_sample(std_tokens, training=True) / device_flops_per_cycle
    kw = dict(cycles_lo=c * 0.9, cycles_hi=c * 1.1,
              samples_per_device=samples_per_device, local_iters=local_iters)
    kw.update(overrides)
    return make_system(gen, n_devices=n_devices, device=device, dtype=dtype,
                       **kw)


def from_config(cfg) -> ArchCost:
    """Build an ArchCost from a model config (duck-typed)."""
    seq = 1  # per-token costs: use seq=1 for the linear terms, attn added by caller
    d = cfg.d_model
    head_dim = cfg.head_dim
    qkv = 2 * d * (cfg.n_heads + 2 * cfg.kv_heads) * head_dim
    out = 2 * cfg.n_heads * head_dim * d
    if getattr(cfg, "n_experts", 0):
        mlp = 2 * 3 * d * cfg.d_ff * cfg.top_k
        expert_params = cfg.n_layers * 3 * d * cfg.d_ff * cfg.n_experts
        active_mlp_params = cfg.n_layers * 3 * d * cfg.d_ff * cfg.top_k
    else:
        mlp = 2 * 3 * d * cfg.d_ff
        expert_params = cfg.n_layers * 3 * d * cfg.d_ff
        active_mlp_params = expert_params
    per_layer = qkv + out + mlp
    embed = 2 * d * cfg.vocab_size
    flops_per_token = cfg.n_layers * per_layer + embed
    attn_params = cfg.n_layers * (d * (cfg.n_heads + 2 * cfg.kv_heads) * head_dim
                                  + cfg.n_heads * head_dim * d)
    params_total = expert_params + attn_params + d * cfg.vocab_size
    params_active = active_mlp_params + attn_params + d * cfg.vocab_size
    return ArchCost(name=cfg.name, flops_per_token=float(flops_per_token),
                    params_active=float(params_active), params_total=float(params_total))
