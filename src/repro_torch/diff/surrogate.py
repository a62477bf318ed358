"""Learned accuracy surrogate: fit A(s) from realized FL training curves.

Port of `repro/diff/surrogate.py`.

The paper's accuracy term is a fixed linear fit through two Fig. 7
operating points. A deployment has something better: its OWN training
runs. This module fits a monotone concave surrogate a(s) to measured
(resolution, accuracy) pairs — e.g. the final eval accuracies of
`fl.server.run_federated` at each rendering resolution — and threads it
back into the allocator as a drop-in `AccuracyModel`.

Model class: piecewise-linear in x = log s through the fitted menu knots,
linearly extrapolated with the end-segment slopes. With knot values
nondecreasing and knot slopes nonincreasing (both enforced by
pool-adjacent-violators projections at fit time), the surrogate is
nondecreasing and concave in x; concavity in s itself follows from
A''(s) = -P'(x)/s^2 <= 0 for P piecewise linear with P' >= 0 — exactly
the regularity SP1's water-filling requires of A'. The dataclass is
frozen with tuple fields, like every other accuracy model.

The fitted model carries its `menu` (the solver-unit resolutions it was
measured at); `problem_with_surrogate` installs model AND menu on a
`Problem` so `round_resolution` / `map_resolution_to_dataset` snap onto
the fitted operating points instead of the Fig. 7 grid
(`core.accuracy.system_with_menu`). `fit_from_training` measures the
points by FedAvg training runs (`fl.server.run_federated`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.accuracy import FIG7_RESOLUTIONS, system_with_menu

Tensor = torch.Tensor

__all__ = ["FitDraws", "SurrogateAccuracy", "fit_from_training",
           "fit_surrogate", "problem_with_surrogate"]


@dataclasses.dataclass(frozen=True)
class SurrogateAccuracy:
    """Monotone concave piecewise-log-linear accuracy model (module
    docstring). `knots` are log-resolutions (strictly increasing),
    `values` the fitted accuracies (nondecreasing, concave over knots),
    `menu` the resolutions fitted on (solver units)."""
    knots: Tuple[float, ...]
    values: Tuple[float, ...]
    menu: Tuple[float, ...]

    def __post_init__(self):
        if len(self.knots) != len(self.values) or len(self.knots) < 2:
            raise ValueError(
                f"SurrogateAccuracy: need >= 2 matching knots/values, got "
                f"{len(self.knots)}/{len(self.values)}")

    def _segment(self, x: Tensor):
        kx = torch.as_tensor(self.knots, dtype=x.dtype, device=x.device)
        kv = torch.as_tensor(self.values, dtype=x.dtype, device=x.device)
        i = torch.clamp(torch.searchsorted(kx, x.detach().contiguous(),
                                           right=True) - 1,
                        0, len(self.knots) - 2)
        slope = (kv[i + 1] - kv[i]) / (kx[i + 1] - kx[i])
        return kv[i] + slope * (x - kx[i]), slope

    def value(self, s: Tensor) -> Tensor:
        s = torch.as_tensor(s)
        v, _ = self._segment(torch.log(torch.clamp_min(s, 1e-12)))
        return v

    def deriv(self, s: Tensor) -> Tensor:
        s = torch.as_tensor(s)
        safe = torch.clamp_min(s, 1e-12)
        _, slope = self._segment(torch.log(safe))
        return slope / safe          # dA/ds = P'(log s) / s


def _pav_nonincreasing(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Weighted pool-adjacent-violators: the nonincreasing sequence
    closest to `y` in the `w`-weighted least-squares sense."""
    vals, wts, sizes = [], [], []
    for yi, wi in zip(y, w):
        vals.append(float(yi)); wts.append(float(wi)); sizes.append(1)
        while len(vals) > 1 and vals[-2] < vals[-1]:
            v2, w2, n2 = vals.pop(), wts.pop(), sizes.pop()
            v1, w1, n1 = vals.pop(), wts.pop(), sizes.pop()
            wt = w1 + w2
            vals.append((v1 * w1 + v2 * w2) / wt)
            wts.append(wt); sizes.append(n1 + n2)
    return np.concatenate([np.full(n, v) for v, n in zip(vals, sizes)])


def fit_surrogate(resolutions: Sequence[float],
                  accuracies: Sequence[float],
                  menu: Optional[Sequence[float]] = None
                  ) -> SurrogateAccuracy:
    """Fit the monotone concave surrogate to measured (s, a) pairs.

    Two projection passes in log-s space: isotonic regression makes the
    knot values nondecreasing (measurement noise routinely produces a
    dip), then a slope-space PAV (weighted by segment width) makes the
    segment slopes nonincreasing — concavity. Slopes are floored at 0 and
    the rebuilt curve is re-centered to the projected values' mean, so
    both shape constraints hold exactly while the level stays unbiased.
    `menu` overrides the stored operating points (defaults to the fitted
    resolutions themselves).
    """
    res = np.asarray(resolutions, float)
    acc = np.asarray(accuracies, float)
    if res.shape != acc.shape or res.ndim != 1 or res.size < 2:
        raise ValueError(
            f"fit_surrogate: need matching 1-D arrays of >= 2 points, got "
            f"{res.shape} vs {acc.shape}")
    order = np.argsort(res)
    res, acc = res[order], acc[order]
    if np.any(np.diff(res) <= 0):
        raise ValueError("fit_surrogate: duplicate resolutions")

    x = np.log(res)
    # monotone: nondecreasing values = -PAV_nonincreasing(-y)
    y = -_pav_nonincreasing(-acc, np.ones_like(acc))
    # concave: nonincreasing (and nonnegative) segment slopes
    dx = np.diff(x)
    m = np.maximum(_pav_nonincreasing(np.diff(y) / dx, dx), 0.0)
    v = np.concatenate([[0.0], np.cumsum(m * dx)])
    v += y.mean() - v.mean()

    menu = res if menu is None else np.asarray(menu, float)
    if menu.shape != res.shape:
        raise ValueError(
            f"fit_surrogate: menu must match the fitted points "
            f"({res.shape}), got {menu.shape}")
    return SurrogateAccuracy(knots=tuple(float(k) for k in x),
                             values=tuple(float(a) for a in v),
                             menu=tuple(float(s) for s in menu))


@dataclasses.dataclass
class FitDraws:
    """The random inputs of `fit_from_training`: the dataset's `FLDraws`
    and one `fl.RunDraws` (initial parameters, eval set) per dataset
    resolution, in the order of `dataset_resolutions`."""
    dataset: Any
    runs: Sequence[Any]


def fit_from_training(key=0, menu: Sequence[float] = FIG7_RESOLUTIONS,
                      dataset_resolutions: Sequence[int] = (8, 16, 24, 32),
                      n_clients: int = 6, per_client: int = 96,
                      num_classes: int = 4, global_rounds: int = 3,
                      local_iters: int = 2, lr: float = 0.05,
                      eval_n: int = 192, split: str = "iid", *,
                      device=None) -> SurrogateAccuracy:
    """Fit the surrogate from realized `fl` training curves.

    One FedAvg run per dataset resolution (every client rendered at that
    resolution, evaluated at it too); the final round's eval accuracy
    becomes that operating point's measurement. `menu` gives the solver-
    unit resolution of each dataset grid point (rank for rank, the same
    correspondence `map_resolution_to_dataset` uses), so the fitted model
    plugs straight into the allocator via `problem_with_surrogate`.

    key: a `FitDraws` (which fix the dataset's sizes, split, device and
        dtype), or a torch.Generator / integer seed that draws the dataset
        at the given sizes on `device` (CUDA by default) in float32, then
        each run's parameters and eval set in turn.
    """
    from ..core.channel import _generator
    from ..fl.data import dataset_draws, make_federated_dataset
    from ..fl.server import run_draws, run_federated

    if len(menu) != len(dataset_resolutions):
        raise ValueError(
            f"fit_from_training: menu ({len(menu)}) and "
            f"dataset_resolutions ({len(dataset_resolutions)}) must "
            f"correspond rank for rank")
    if isinstance(key, FitDraws):
        ds = make_federated_dataset(key.dataset)
        runs = key.runs
    else:
        gen = _generator(key)
        ds = make_federated_dataset(dataset_draws(
            gen, n_clients, per_client, num_classes,
            int(max(dataset_resolutions)), split, device=device))
        runs = [run_draws(gen, ds, eval_n) for _ in dataset_resolutions]
    if len(runs) != len(dataset_resolutions):
        raise ValueError(
            f"fit_from_training: {len(runs)} run draws for "
            f"{len(dataset_resolutions)} dataset resolutions")
    accs = []
    for draws, r in zip(runs, dataset_resolutions):
        run = run_federated(
            draws, ds, [int(r)] * ds.n_clients, global_rounds=global_rounds,
            local_iters=local_iters, lr=lr, eval_resolution=int(r))
        accs.append(run.round_accuracy[-1])
    return fit_surrogate(menu, accs, menu=menu)


def problem_with_surrogate(problem, acc: SurrogateAccuracy):
    """Install a fitted surrogate on a `Problem`: accuracy model AND its
    resolution menu (so the discrete snap targets the fitted operating
    points — satellite of the menu round-trip fix)."""
    return dataclasses.replace(
        problem, acc=acc, system=system_with_menu(problem.system, acc))
