"""Bring `repro`'s systems and allocations over to the port.

The caller hands over numpy arrays (`np.asarray` of each `repro` leaf, done
on the `repro` side); this module imports nothing of `repro`. A stacked
`repro` system has (C,) per-cell scalars, which become (C, 1) here.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .core.types import (ALLOC_FIELDS, SYS_ARRAYS, SYS_SCALARS, Allocation,
                         SystemParams, resolve_device)


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype).to(device)


def system_from_numpy(leaves: Mapping[str, np.ndarray],
                      resolutions: Sequence[float], device=None,
                      dtype: Optional[torch.dtype] = None) -> SystemParams:
    """A `SystemParams` from a dict of numpy leaves: the device arrays
    ("gain", "cycles", "samples", "bits"), the per-cell scalars, and
    optionally "active". `dtype` None keeps the arrays' own float type."""
    dev = resolve_device(device)
    arrays = {k: _tensor(leaves[k], dtype, dev) for k in SYS_ARRAYS}
    stacked = arrays["gain"].ndim == 2
    dt = arrays["gain"].dtype
    scalars = {}
    for k in SYS_SCALARS:
        v = _tensor(leaves[k], dt, dev)
        scalars[k] = v.reshape(-1, 1) if stacked else v.reshape(())
    act = leaves.get("active")
    active = None if act is None \
        else torch.as_tensor(np.array(act, dtype=bool)).to(dev)
    return SystemParams(**arrays, **scalars,
                        resolutions=tuple(float(r) for r in resolutions),
                        active=active)


def allocation_from_numpy(leaves: Mapping[str, np.ndarray], device=None,
                          dtype: Optional[torch.dtype] = None) -> Allocation:
    """An `Allocation` from a dict of numpy leaves ("bandwidth", "power",
    "freq", "resolution", and optionally "s_relaxed", "T")."""
    dev = resolve_device(device)
    return Allocation(**{k: None if leaves.get(k) is None
                         else _tensor(leaves[k], dtype, dev)
                         for k in ALLOC_FIELDS})
