"""Bring `repro`'s systems, allocations, random draws and model parameters
over to the port.

The caller hands over numpy arrays (`np.asarray` of each `repro` leaf, done
on the `repro` side); this module imports nothing of `repro`. A stacked
`repro` system has (C,) per-cell scalars, which become (C, 1) here; a
model's parameters, stacked over layer periods there, are unstacked into
one module per period. The round engine and the mobility traces take their
draws as inputs, so a caller can feed them the reference's `jax.random`
draws (`round_draws_from_numpy`, `mobility_draws_from_numpy`), as do the
FL datasets (`fl_draws_from_numpy`); `cnn_params_from_numpy` carries the
client CNN's parameters over.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.types import (ALLOC_FIELDS, SYS_ARRAYS, SYS_SCALARS, Allocation,
                         SystemParams, resolve_device)
from .dynamics.engine import RoundDraws
from .dynamics.mobility import MobilityDraws
from .fl.data import FLDraws, SampleDraws


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


def round_draws_from_numpy(shadow0: np.ndarray, z: np.ndarray,
                           drop: np.ndarray, device=None,
                           dtype: Optional[torch.dtype] = None) -> RoundDraws:
    """A `RoundDraws` from numpy arrays: shadow0 (C, N) or (N,), z (C, R, N)
    or (R, N), drop of z's shape (bool). `dtype` None keeps z's float
    type."""
    dev = resolve_device(device)
    return RoundDraws(shadow0=_tensor(shadow0, dtype, dev),
                      z=_tensor(z, dtype, dev),
                      drop=torch.as_tensor(np.array(drop, dtype=bool)).to(dev))


def mobility_draws_from_numpy(leaves: Mapping[str, np.ndarray], device=None,
                              dtype: Optional[torch.dtype] = None
                              ) -> MobilityDraws:
    """A `MobilityDraws` from a dict of numpy arrays keyed by its field
    names (pos0, v0, step_xy, and optionally wp0, step_v, shadow0,
    shadow_z)."""
    dev = resolve_device(device)
    return MobilityDraws(**{k: None if leaves.get(k) is None
                            else _tensor(leaves[k], dtype, dev)
                            for k in ("pos0", "v0", "step_xy", "wp0",
                                      "step_v", "shadow0", "shadow_z")})


def fl_draws_from_numpy(labels: np.ndarray, shift: np.ndarray,
                        smooth: np.ndarray, pix: np.ndarray,
                        templates: Optional[Sequence[np.ndarray]] = None,
                        frac: Optional[np.ndarray] = None, device=None,
                        dtype: Optional[torch.dtype] = None) -> FLDraws:
    """An `fl.data.FLDraws` from numpy arrays: the labels, one `_sample`
    call's shift / smooth / pix draws, and for a federated dataset the
    per-scale template normals and the Dirichlet fractions. `dtype` None
    keeps each float array's own type."""
    dev = resolve_device(device)

    def ints(x):
        return torch.as_tensor(np.array(x, dtype=np.int64)).to(dev)

    return FLDraws(
        labels=ints(labels),
        sample=SampleDraws(shift=ints(shift), smooth=_tensor(smooth, dtype,
                                                             dev),
                           pix=_tensor(pix, dtype, dev)),
        templates=None if templates is None
        else tuple(_tensor(t, dtype, dev) for t in templates),
        frac=None if frac is None else _tensor(frac, dtype, dev))


def cnn_params_from_numpy(tree: Mapping, device=None,
                          dtype: Optional[torch.dtype] = None):
    """The client CNN's parameters (`models.cnn.Params`) from the
    reference's nested dict of numpy arrays: each convolution's HWIO
    kernel becomes OIHW, the head's (in, classes) matrix (classes, in)."""
    dev = resolve_device(device)
    out = {}
    for layer, leaves in tree.items():
        w = np.asarray(leaves["w"])
        w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
        out[layer] = dict(w=_tensor(w, dtype, dev).contiguous(),
                          b=_tensor(leaves["b"], dtype, dev))
    return out


def _leaf(tree: Mapping, path: Sequence[str]) -> np.ndarray:
    node = tree
    for part in path:
        if not isinstance(node, Mapping) or part not in node:
            raise KeyError(f"model_params_from_numpy: no leaf "
                           f"{'/'.join(path)} in the parameter tree")
        node = node[part]
    return node


def _count_leaves(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def model_params_from_numpy(tree: Mapping, cfg: ModelConfig, device=None,
                            dtype: Optional[torch.dtype] = None):
    """A `models.transformer.Model` of `cfg` holding the parameters of a
    `repro` parameter tree, handed over as nested dicts of numpy arrays
    (the reference's `init_model` layout: "embed", "final_norm", optional
    "lm_head", "layers" with every leaf stacked over periods on axis 0,
    and for an encoder config "encoder", stacked over encoder layers on
    axis 0, and "enc_final_norm"). Port parameter
    `layers.i.<slot>.<...>.<leaf>` takes `tree["layers"][<slot>]...
    [<leaf>][i]`, `encoder.i.<...>.<leaf>` takes `tree["encoder"]...
    [<leaf>][i]`; every other parameter takes the leaf of the same dotted
    path. bfloat16 leaves (ml_dtypes) are read through float32. `dtype`
    None keeps each parameter's own dtype (the config's for weights,
    float32 for norms, decays and mixes)."""
    from .models.transformer import init_model

    stacked = {"layers": cfg.n_periods, "encoder": cfg.encoder_layers}
    model = init_model(cfg, 0, device)
    used = 0
    with torch.no_grad():
        for name, param in model.named_parameters():
            parts = name.split(".")
            if parts[0] in stacked:
                arr = _leaf(tree, [parts[0], *parts[2:]])[int(parts[1])]
            else:
                arr = _leaf(tree, parts)
            arr = np.asarray(arr)
            if arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"model_params_from_numpy: {name} has shape "
                                 f"{tuple(param.shape)}, the tree's leaf "
                                 f"{tuple(arr.shape)}")
            dt = param.dtype if dtype is None else dtype
            param.data = torch.tensor(arr).to(device=param.device, dtype=dt)
            used += 1
    expect = sum(_count_leaves(v) * stacked.get(k, 1)
                 for k, v in tree.items())
    if used != expect:
        raise ValueError(f"model_params_from_numpy: the tree holds {expect} "
                         f"per-layer leaves, the port's model {used}")
    return model
