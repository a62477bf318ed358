"""Bucketed request batching: pad mixed-size cell pools onto a power-of-two
shape menu.

Port of `repro/region/batch.py`. Every pool is padded up to
`bucket_size(N)` (the next power of two, floored at `min_bucket`) with
masked devices:

  * zero data (cycles = samples = bits = 0): a padded device computes and
    uploads nothing, so its SP1 dual term is exactly 0 (the
    `sp1_lambda_sum` kernel returns lambda = 0 for a q = 0, tt = 0 lane at
    every finite deadline) and its makespan is 0;
  * zero bandwidth: `sys.active` collapses its SP2 box to [0, 0], so it is
    pinned at B = 0;
  * excluded from makespan, energy and accuracy by the `active` mask that
    the SP1, SP2 and BCD reductions thread through.

Where the reference takes an array namespace (`xp=`: jnp on the device,
numpy on the host), these take a `device`: the default is the system's
own, and `device="cpu"` assembles a batch on the host. Padding is pure
data movement, so both give the same values.
"""
from __future__ import annotations

import torch

from ..core.types import Allocation, SystemParams

Tensor = torch.Tensor

DEFAULT_MIN_BUCKET = 64


def bucket_size(n: int, min_bucket: int = DEFAULT_MIN_BUCKET) -> int:
    """Smallest power of two >= n, floored at `min_bucket`: the batch-shape
    menu for mixed-size cell pools. A pool spanning device counts up to 16x
    the floor takes at most 5 distinct shapes."""
    if n <= 0:
        raise ValueError(f"bucket_size: need n >= 1, got {n}")
    return max(min_bucket, 1 << (n - 1).bit_length())


def _pad_tail(x: Tensor, pad: int, fill, device) -> Tensor:
    x = x.to(device)
    tail = torch.full(x.shape[:-1] + (pad,), fill, dtype=x.dtype,
                      device=device)
    return torch.cat([x, tail], -1)


def pad_system(sys: SystemParams, n_pad: int, device=None) -> SystemParams:
    """Pad a SystemParams ((N,) or a (C, N) stack) to `n_pad` devices with
    masked, data-free lanes.

    The result always carries an `active` mask (all True over the original
    devices), even when n_pad == N, so that systems from different pools
    stack into one batch. Padded lanes get gain = 1 (any positive value; it
    only guards divisions), zero cycles, samples and bits, and
    active = False. Per-cell scalars move to `device` unchanged."""
    device = sys.device if device is None else torch.device(device)
    n = sys.n
    if n_pad < n:
        raise ValueError(f"pad_system: n_pad={n_pad} < n={n}")
    pad = n_pad - n
    active = sys.active if sys.active is not None \
        else torch.ones(sys.gain.shape, dtype=torch.bool)
    moved = sys.to(device)
    return moved.replace(
        gain=_pad_tail(sys.gain, pad, 1.0, device),
        cycles=_pad_tail(sys.cycles, pad, 0.0, device),
        samples=_pad_tail(sys.samples, pad, 0.0, device),
        bits=_pad_tail(sys.bits, pad, 0.0, device),
        active=_pad_tail(active, pad, False, device),
    )


def inactive_system(template: SystemParams, device=None) -> SystemParams:
    """An all-masked batch filler shaped like `template`: every lane
    inactive, zero data (gain = 1 to guard divisions).

    A fully inactive cell sits at the masked fixed point: its (masked) BCD
    rel-step is exactly 0, so it reports convergence after one iteration,
    and the real cells of the batch are unaffected (cells are
    independent)."""
    device = template.device if device is None else torch.device(device)
    shape, dt = template.gain.shape, template.dtype

    def full(v):
        return torch.full(shape, v, dtype=dt, device=device)

    return template.to(device).replace(
        gain=full(1.0), cycles=full(0.0), samples=full(0.0), bits=full(0.0),
        active=torch.zeros(shape, dtype=torch.bool, device=device))


def pad_allocation(alloc: Allocation, n_pad: int, sys: SystemParams,
                   device=None) -> Allocation:
    """Pad a warm-start Allocation ((N,) or (C, N)) to `n_pad` devices.

    Pad lanes are filled with the masked solve's fixed point (B = 0,
    p = p_min, f = f_min, s = s_hi), so they add nothing to the (masked)
    BCD rel-step and a cached solution behaves as its unpadded warm start.
    `sys` supplies the box values (per-cell scalars on a stack)."""
    device = alloc.bandwidth.device if device is None \
        else torch.device(device)
    n = alloc.bandwidth.shape[-1]
    pad = int(n_pad) - int(n)
    if pad < 0:
        raise ValueError(f"pad_allocation: n_pad={n_pad} < n={n}")
    if pad == 0:
        return alloc
    lead = alloc.bandwidth.shape[:-1]
    dt = alloc.bandwidth.dtype

    def tail(fill):
        v = torch.as_tensor(fill, dtype=dt).to(device)   # 0-d or (C, 1)
        return torch.broadcast_to(v, lead + (pad,))

    def cat(x, fill):
        return torch.cat([x.to(device=device, dtype=dt), tail(fill)], -1)

    return Allocation(
        bandwidth=cat(alloc.bandwidth, 0.0),
        power=cat(alloc.power, sys.p_min),
        freq=cat(alloc.freq, sys.f_min),
        resolution=cat(alloc.resolution, sys.s_hi),
        s_relaxed=None if alloc.s_relaxed is None
        else cat(alloc.s_relaxed, sys.s_hi),
        T=alloc.T)
