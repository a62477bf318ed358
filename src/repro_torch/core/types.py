"""Core datatypes for the FL-MAR resource-allocation system (paper §III).

Port of `repro/core/types.py`. All quantities are SI: Hz, watts, joules,
seconds, bits, CPU cycles.

Layout (batched first, in place of `jax.vmap`): per-device tensors are
(N,) for one cell or (C, N) for a stack of cells; per-cell scalars are 0-d
for one cell or (C, 1) for a stack, so they broadcast against the device
axis without any per-cell loop. Reductions over devices keep that axis as
size 1 (see `core.energy`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

Tensor = torch.Tensor


def dbm_to_watt(dbm: float) -> float:
    return 10.0 ** (dbm / 10.0) * 1e-3


# Paper §VII-A defaults.
DEFAULTS = dict(
    n_devices=50,
    area_m=500.0,             # devices uniform in a 500m x 500m square, BS at center
    bandwidth_total=20e6,     # B  (Hz)
    noise_psd=dbm_to_watt(-174.0),   # N0 (W/Hz)
    p_max=dbm_to_watt(12.0),  # 12 dBm
    p_min=dbm_to_watt(0.0),   # 0 dBm
    f_max=2e9,                # 2 GHz
    f_min=1e3,                # paper: 0 Hz; a tiny positive floor
    kappa=1e-28,              # effective switched capacitance
    cycles_lo=1e4,            # c_n ~ U[1,3]x1e4 cycles / standard sample
    cycles_hi=3e4,
    samples_per_device=500,   # D_n
    upload_bits=28.1e3,       # d_n
    local_iters=10,           # R_l
    global_rounds=100,        # R_g
    resolutions=(160.0, 320.0, 480.0, 640.0),   # s_bar_1..s_bar_M (pixels)
    s_standard=160.0,
    shadowing_db=8.0,
)

# per-cell scalar fields and per-device array fields of SystemParams
SYS_SCALARS = ("bandwidth_total", "noise_psd", "p_min", "p_max", "f_min",
               "f_max", "kappa", "local_iters", "global_rounds", "s_standard")
SYS_ARRAYS = ("gain", "cycles", "samples", "bits")
ALLOC_FIELDS = ("bandwidth", "power", "freq", "resolution", "s_relaxed", "T")


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The device an entry point builds on: CUDA unless the caller names
    another. There is no silent CPU fallback: without CUDA the caller must
    ask for `device="cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available; pass device='cpu' to run "
            "on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class SystemParams:
    """One FL-MAR system instance (N devices), or a stack of C of them.

    `resolutions` (the discrete s-menu, ascending) is static and shared by
    every cell of a stack. `active` is an optional (N,)/(C, N) bool mask of
    padded-out devices, excluded from every cross-device reduction."""
    # per-device tensors, (N,) or (C, N)
    gain: Tensor         # E[G_n] expected channel gain (linear)
    cycles: Tensor       # c_n cycles per standard sample
    samples: Tensor      # D_n
    bits: Tensor         # d_n upload size in bits
    # per-cell scalars, 0-d or (C, 1)
    bandwidth_total: Tensor
    noise_psd: Tensor
    p_min: Tensor
    p_max: Tensor
    f_min: Tensor
    f_max: Tensor
    kappa: Tensor
    local_iters: Tensor  # R_l
    global_rounds: Tensor  # R_g
    resolutions: tuple   # (s_bar_1..s_bar_M), ascending — static
    s_standard: Tensor
    active: Optional[Tensor] = None

    @property
    def n(self) -> int:
        return int(self.gain.shape[-1])

    @property
    def cells(self) -> Optional[int]:
        """C for a stacked (C, N) system, None for a single cell."""
        if self.gain.ndim == 1:
            return None
        if self.gain.ndim == 2:
            return int(self.gain.shape[0])
        raise ValueError(f"SystemParams: gain must be (N,) or (C, N), got "
                         f"{tuple(self.gain.shape)}")

    @property
    def device(self) -> torch.device:
        return self.gain.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gain.dtype

    @property
    def zeta(self) -> Tensor:
        # zeta = 1 / s_standard^2  (paper eq. 7)
        return 1.0 / (self.s_standard * self.s_standard)

    @property
    def s_lo(self) -> float:
        return float(self.resolutions[0])

    @property
    def s_hi(self) -> float:
        return float(self.resolutions[-1])

    def replace(self, **kw) -> "SystemParams":
        return dataclasses.replace(self, **kw)

    def batched(self) -> "SystemParams":
        """The (C, N) / (C, 1) view the solvers work on; a single cell
        becomes C = 1. Idempotent on a stack."""
        if self.gain.ndim == 2:
            return self
        arrays = {k: getattr(self, k).unsqueeze(0) for k in SYS_ARRAYS}
        scalars = {k: getattr(self, k).reshape(1, 1) for k in SYS_SCALARS}
        act = None if self.active is None else self.active.unsqueeze(0)
        return SystemParams(**arrays, **scalars,
                            resolutions=self.resolutions, active=act)

    def cell(self, c: int) -> "SystemParams":
        """Single-cell view of a stacked (C, N) system: row `c` of every
        tensor."""
        if self.gain.ndim != 2:
            raise ValueError("SystemParams.cell: system is not stacked (C, N)")
        take = {k: getattr(self, k)[c] for k in SYS_ARRAYS}
        take.update({k: getattr(self, k)[c].reshape(())
                     for k in SYS_SCALARS})
        act = None if self.active is None else self.active[c]
        return SystemParams(**take, resolutions=self.resolutions, active=act)

    def with_assignment(self, assign) -> "SystemParams":
        """Cross-cell active views under a device -> cell assignment.

        For a stacked (C, N) system whose row c holds every device's gain
        to cell c, an association is an (N,) int array or tensor
        (`assign[n]` = serving cell, -1 = unserved). The result carries
        ``active[c, n] = (assign[n] == c) & base_active[c, n]``, so each
        cell's lane solves exactly its member devices at the one (C, N)
        shape."""
        if self.gain.ndim != 2:
            raise ValueError(
                "SystemParams.with_assignment: system is not stacked (C, N)")
        C = self.gain.shape[0]
        assign = torch.as_tensor(assign, device=self.device)
        mask = assign[None, :] == torch.arange(C, device=self.device)[:, None]
        if self.active is not None:
            mask = mask & self.active
        return self.replace(active=mask)

    def to(self, device=None, dtype: Optional[torch.dtype] = None
           ) -> "SystemParams":
        """Move to `device` and cast floating tensors to `dtype` (the
        bool `active` mask keeps its type)."""
        def move(x):
            if x is None:
                return None
            if dtype is not None and x.is_floating_point():
                return x.to(device=device, dtype=dtype)
            return x.to(device=device)
        leaves = {k: move(getattr(self, k))
                  for k in SYS_ARRAYS + SYS_SCALARS + ("active",)}
        return SystemParams(**leaves, resolutions=self.resolutions)


@dataclasses.dataclass(frozen=True)
class Weights:
    """Objective weights (paper eq. 12). w1 + w2 is normalized to 1.

    Fields may be Python scalars (one cell) or tensors (per-cell weights,
    (C, 1) to broadcast against a stack)."""
    w1: Union[float, Tensor]
    w2: Union[float, Tensor]
    rho: Union[float, Tensor]

    def normalized(self) -> "Weights":
        s = self.w1 + self.w2
        if bool(torch.as_tensor(s).le(0).any()):
            raise ValueError("w1 + w2 must be positive (paper §VII-A footnote)")
        return Weights(self.w1 / s, self.w2 / s, self.rho / s)


@dataclasses.dataclass
class Allocation:
    """A resource allocation decision: per-device tensors, (N,) or (C, N)."""
    bandwidth: Tensor   # B_n (Hz)
    power: Tensor       # p_n (W)
    freq: Tensor        # f_n (Hz)
    resolution: Tensor  # s_n (pixels), one of the discrete choices
    s_relaxed: Optional[Tensor] = None  # continuous \hat{s} before rounding
    T: Optional[Tensor] = None          # per-round makespan auxiliary variable

    def astuple(self):
        return (self.bandwidth, self.power, self.freq, self.resolution)

    def to(self, device=None, dtype: Optional[torch.dtype] = None
           ) -> "Allocation":
        return Allocation(**{
            k: None if getattr(self, k) is None
            else getattr(self, k).to(device=device, dtype=dtype)
            for k in ALLOC_FIELDS})
