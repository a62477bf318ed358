"""FL-MAR system simulator: couples the allocator to actual federated
training and keeps the paper's energy / time ledger.

Port of `repro/fl/simulator.py`. The end-to-end loop of the paper's
Fig. 1: allocate -> each device trains locally at its allocated resolution
/ CPU frequency -> uploads over its allocated (p_n, B_n) channel -> FedAvg
-> repeat; the ledger accumulates eqs. (2), (3), (8), (10).

One cold `solve` seeds the round-dynamics engine (`Problem.rounds`), which
runs the R global rounds on the device (sampled channel gains, warm-started
re-allocation, and the straggler / dropout / staleness participation whose
per-device codes feed the staleness-weighted FedAvg in `fl.server`). The
default (static channels, full participation) reproduces the
allocate-once ledger.

The three random streams of the reference (the dataset, the FL run, the
dynamics) are separate inputs (`SimDraws`), or come from one
`torch.Generator`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from ..api import Problem, SolverSpec, solve
from ..core.accuracy import AccuracyModel, default_accuracy
from ..core.channel import _generator
from ..core.types import Allocation, SystemParams, Weights
from ..dynamics import RoundsConfig, RoundsResult
from .data import FLDataset, FLDraws, dataset_draws, make_federated_dataset
from .server import FLRunResult, run_federated

Tensor = torch.Tensor


def map_resolution_to_dataset(sys: SystemParams, resolution: Tensor,
                              dataset_resolutions: Sequence[int]) -> Tensor:
    """Map the allocator's s_n onto the dataset's rendering grid by
    RELATIVE menu position (rank), not raw index.

    The snap targets `sys.resolutions` (whatever menu the system solves
    on, e.g. one attached by a fitted surrogate), and the menu rank is then
    rescaled onto the dataset grid and rounded half to even, so a 6-point
    solver menu and a 4-point dataset grid still correspond monotonically.
    Menus of equal length map index for index. Returns an int32 tensor of
    dataset resolutions on `resolution`'s device."""
    resolution = torch.as_tensor(resolution)
    menu = torch.as_tensor(sys.resolutions, dtype=resolution.dtype,
                           device=resolution.device)
    idx = (resolution[..., None] - menu).abs().argmin(-1)
    n_menu = max(len(sys.resolutions) - 1, 1)
    n_ds = len(dataset_resolutions) - 1
    j = torch.round(idx.to(resolution.dtype) * (n_ds / n_menu))
    grid = torch.as_tensor(dataset_resolutions, dtype=torch.int32,
                           device=resolution.device)
    return grid[j.long()]


@dataclasses.dataclass
class SimResult:
    allocation: Allocation
    fl: FLRunResult
    ledger: Dict[str, float]
    rounds: Optional[RoundsResult] = None


@dataclasses.dataclass
class SimDraws:
    """The random inputs of `simulate`, one per stream of the reference.

    run: the FL run's `RunDraws` (the CNN's initial parameters, the eval
        set), or a generator / seed for them.
    rounds: `Problem.key` of the rounds solve: a `dynamics.RoundDraws`, a
        torch.Generator on the system's device, or an integer seed.
    dataset: the `FLDraws` of the dataset, read only when `simulate` is
        given no dataset.
    """
    run: Any
    rounds: Any
    dataset: Optional[FLDraws] = None


def simulate(key, sys: SystemParams, w: Weights,
             acc_model: Optional[AccuracyModel] = None,
             dataset: Optional[FLDataset] = None,
             dataset_resolutions: Sequence[int] = (8, 16, 24, 32),
             global_rounds: int = 10, local_iters: int = 5,
             lr: float = 0.05, split: str = "iid",
             unbalanced: bool = False,
             dynamics: Optional[RoundsConfig] = None,
             spec: Optional[SolverSpec] = None) -> SimResult:
    """Allocate resources, run FedAvg at the allocated resolutions, and
    return the realized energy / time ledger (paper eqs. 9 & 11).

    key: a `SimDraws`, or a torch.Generator / integer seed that draws, in
        order, the dataset (when `dataset` is None, one client a device at
        the reference's default sizes, on the system's device and in its
        dtype), a seed for the rounds' draws, and the FL run's draws.
    dynamics: optional RoundsConfig for the round engine (channel fading,
        stragglers, staleness); `rounds` is forced to `global_rounds` so the
        physics and the FL training see the same number of rounds. The
        default is the static / full-participation config, which reproduces
        the allocate-once ledger.
    spec: SolverSpec for the seeding cold solve (default max_iters=8). The
        per-round solver options come from `dynamics` itself.
    """
    if dynamics is None:
        cfg = RoundsConfig(rounds=global_rounds, bcd_iters=0)
    else:
        cfg = dynamics
        if cfg.rounds != global_rounds:
            cfg = dataclasses.replace(cfg, rounds=global_rounds)
    if not isinstance(key, SimDraws):
        gen = _generator(key)
        ds_draws = None if dataset is not None else dataset_draws(
            gen, n_clients=sys.n, split=split, device=sys.device,
            dtype=sys.dtype)
        key = SimDraws(dataset=ds_draws, run=gen,
                       rounds=int(torch.randint(0, 2 ** 62, (),
                                                generator=gen)))
    if dataset is None:
        dataset = make_federated_dataset(key.dataset, unbalanced=unbalanced)
    if dataset.n_clients != sys.n:
        raise ValueError("simulate: one device per FL client "
                         f"({dataset.n_clients} clients, {sys.n} devices)")

    acc = acc_model if acc_model is not None else default_accuracy()
    # one full cold solve seeds the engine either way: the static path holds
    # it fixed (bcd_iters=0, no per-round re-solve), the dynamics path
    # warm-starts round 1 from it so no round trains on an unconverged
    # cold-capped allocation
    seed_spec = spec if spec is not None else SolverSpec(max_iters=8)
    init = solve(Problem(system=sys, weights=w, acc=acc), seed_spec).allocation
    rr = solve(Problem(system=sys, weights=w, acc=acc, init=init,
                       rounds=cfg, key=key.rounds))
    # clients pre-render at the ROUND-0 resolutions: round 0's training
    # can't see the final round's channel state (under the static default
    # all rounds allocate identically)
    ds_res = map_resolution_to_dataset(sys, rr.resolutions[0],
                                       dataset_resolutions)

    staleness = None if dynamics is None else rr.staleness
    fl = run_federated(key.run, dataset, ds_res,
                       global_rounds=global_rounds, local_iters=local_iters,
                       lr=lr, staleness=staleness,
                       staleness_decay=cfg.staleness_decay)

    ledger = dict(
        rr.totals(),
        final_accuracy=fl.round_accuracy[-1] if fl.round_accuracy
        else float("nan"),
        mean_resolution=float(rr.resolutions.mean()),
    )
    return SimResult(allocation=rr.allocation, fl=fl, ledger=ledger,
                     rounds=rr)

