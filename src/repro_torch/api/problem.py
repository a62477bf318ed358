"""`Problem` — the single description of *what* to solve.

Port of `repro/api/problem.py`. A Problem bundles the system snapshot, the
objective weights and the optional extras; `solve` routes on its topology:

  * ``system.gain`` (N,)           -> single-cell BCD
  * ``system.gain`` (C, N)         -> fleet (every cell in one batch)
  * ``deadline`` set               -> the deadline-constrained BCD, single
                                      cell or fleet
  * ``rounds`` set                 -> the round-dynamics engine, single
                                      cell or fleet
  * ``mesh`` set (a (C, N) stack)  -> the cell axis split over a
                                      `region.RegionMesh`
  * ``assoc`` set                  -> not ported yet (NotImplementedError)

Weights are data: `weights_leaf` lowers them to a (3,) / (C, 3) tensor,
so every cell can weigh energy / latency / accuracy differently.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from ..core.accuracy import AccuracyModel
from ..core.types import Allocation, SystemParams, Weights

Tensor = torch.Tensor

#: anything `weights_leaf` lowers: a Weights (scalar or (C,) fields), a
#: per-cell sequence of Weights, or a raw (3,)/(C, 3) array-like
WeightsLike = Union[Weights, Sequence[Weights], Tensor, np.ndarray,
                    Sequence[float]]


def weights_leaf(w: WeightsLike, dtype: torch.dtype, device=None,
                 cells: Optional[int] = None) -> Tensor:
    """Lower weights to the tensor the solvers consume.

    Returns a normalized (3,) tensor (single cell) or (C, 3) tensor
    (stacked topologies, with scalar weights broadcast to every cell).
    `Weights` instances are normalized by `Weights.normalized()` before
    the cast to `dtype`; raw arrays are cast, then normalized along their
    last axis.
    """
    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    if isinstance(w, Weights):
        w = w.normalized()
        arr = torch.stack(torch.broadcast_tensors(t(w.w1), t(w.w2),
                                                  t(w.rho)), -1)
    elif isinstance(w, (list, tuple)) and w and isinstance(w[0], Weights):
        rows = [wc.normalized() for wc in w]
        arr = t([[float(wc.w1), float(wc.w2), float(wc.rho)] for wc in rows])
    else:
        arr = t(w)
        if arr.ndim == 0 or arr.shape[-1] != 3:
            raise ValueError(
                f"weights_leaf: expected (3,) or (C, 3) (w1, w2, rho) "
                f"values, got shape {tuple(arr.shape)}")
        s = arr[..., 0] + arr[..., 1]
        if bool((s <= 0).any()):   # same contract as Weights.normalized()
            raise ValueError(
                "w1 + w2 must be positive (paper §VII-A footnote)")
        arr = arr / s[..., None]
    if arr.ndim > 2:
        raise ValueError(f"weights_leaf: too many axes ({tuple(arr.shape)})")
    if cells is None:
        if arr.ndim != 1:
            raise ValueError(
                f"weights_leaf: single-cell problem, but weights have a "
                f"cell axis ({tuple(arr.shape)})")
        return arr
    if arr.ndim == 1:
        return arr.expand(cells, 3)
    if arr.shape[0] != cells:
        raise ValueError(
            f"weights_leaf: {arr.shape[0]} weight rows for {cells} cells")
    return arr


@dataclasses.dataclass
class Problem:
    """One allocation problem: system + weights + optional extras.

    Fields
    ------
    system : a `SystemParams` — (N,) tensors are one cell, (C, N) tensors
        (from `stack_systems` / `make_fleet`) a fleet.
    weights : objective weights — a `Weights`, a per-cell sequence of
        `Weights`, or a raw (3,)/(C, 3) array.
    acc : accuracy model (default `default_accuracy()`).
    init : warm-start `Allocation` (tensors shaped like the system's).
    deadline : total training-time budget (all global rounds) of the
        deadline-constrained variant (paper Figs. 8-9): a scalar, or on a
        (C, N) stack a (C,) per-cell array.
    bandwidth_frac : share of the budget the deadline variant's start
        splits equally (Fig. 9 starts from B/(2N), 0.5).
    rounds : a `dynamics.RoundsConfig`: solve runs R rounds of the
        round-dynamics engine; the per-round solver options (bcd_iters,
        bcd_tol, sp*_method) come from the config, not from `SolverSpec`.
    key : the draws of a rounds problem (required with `rounds`): a
        `dynamics.RoundDraws`, a `torch.Generator` on the system's device,
        or an integer seed for one.
    mesh : a `region.RegionMesh` (`region_mesh`): a (C, N) stack's cells
        are split over its devices (free, deadline and rounds solves).
    assoc : the association topology of `repro.api.Problem`, which a later
        slice ports; `solve` raises NotImplementedError when it is set.
    """
    system: SystemParams
    weights: WeightsLike
    acc: Optional[AccuracyModel] = None
    init: Optional[Allocation] = None
    mesh: Optional[Any] = None
    rounds: Optional[Any] = None
    key: Optional[Any] = None
    deadline: Optional[Union[float, Sequence[float], Tensor]] = None
    bandwidth_frac: float = 1.0
    assoc: Optional[Any] = None

    @property
    def cells(self) -> Optional[int]:
        """C for a stacked (C, N) system, None for a single cell."""
        return self.system.cells
