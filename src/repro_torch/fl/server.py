"""FedAvg server (paper §III): weighted parameter averaging across clients.

Port of `repro/fl/server.py`: `fedavg`, the staleness-aware
`fedavg_stale`, and `run_federated`, the single-host FedAvg loop over
clients with the round-dynamics engine's staleness codes. Its random
inputs (the CNN's initial parameters and the eval set's draws) are a
`RunDraws`, or are made from a `torch.Generator`.

Clients train one after another, each on its own shard at its own
resolution; the losses of a round cross to the host once, after its last
client.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.channel import GeneratorLike, _generator
from ..models.cnn import Params, init_cnn
from ..models.cnn import accuracy as eval_accuracy
from .client import local_train
from .data import FLDataset, FLDraws, eval_draws, make_eval_set, render

Tensor = torch.Tensor


def fedavg(params_list: Sequence[Params], weights) -> Params:
    """w_global = sum_n (D_n / D) w_n   (the paper's global model, §III).
    Each leaf is Python's `sum` of `w * leaf` from 0, in client order."""
    like = next(iter(next(iter(params_list[0].values())).values()))
    wn = torch.as_tensor(weights, dtype=like.dtype, device=like.device)
    wn = wn / wn.sum()
    return {layer: {leaf: sum(w * p[layer][leaf]
                              for w, p in zip(wn, params_list))
                    for leaf in d}
            for layer, d in params_list[0].items()}


def stale_weights(sizes, staleness, decay: float) -> Tensor:
    """Staleness-discounted FedAvg mass: D_n * decay^k for an update that
    arrives k rounds late (k = 0 is on time)."""
    sizes = torch.as_tensor(sizes, dtype=torch.float64)
    return sizes * torch.as_tensor(decay, dtype=torch.float64) \
        ** torch.as_tensor(staleness)


def fedavg_stale(global_params: Params, updates: Sequence[Params],
                 eff_weights: Sequence[float],
                 total_weight: float) -> Params:
    """Staleness-aware aggregation hook for the round-dynamics engine.

    Updates arriving this round aggregate with their (already discounted)
    effective mass; the mass that did not arrive (dropped devices plus the
    discount lost to staleness) anchors to the current global model, so
    full on-time participation reduces exactly to plain `fedavg` and an
    empty arrival set leaves the model unchanged.
    """
    if not updates:
        return global_params
    anchor = max(float(total_weight) - float(sum(eff_weights)), 0.0)
    return fedavg(list(updates) + [global_params],
                  list(eff_weights) + [anchor])


def resolve_eval_resolution(eval_resolution: Optional[int],
                            resolutions: Sequence[int]) -> int:
    """The eval resolution: an explicit one (>= 1 pixel, else ValueError),
    or the median of the clients' resolutions."""
    if eval_resolution is not None:
        if int(eval_resolution) < 1:
            raise ValueError(
                f"eval_resolution must be >= 1 pixel, got {eval_resolution}")
        return int(eval_resolution)
    if isinstance(resolutions, Tensor):
        resolutions = resolutions.tolist()
    rs = sorted(int(r) for r in resolutions)
    return rs[len(rs) // 2]


@dataclasses.dataclass
class RunDraws:
    """The random inputs of `run_federated`: the CNN's initial parameters
    and the eval set's draws."""
    params: Params
    eval: FLDraws


def run_draws(gen: GeneratorLike, ds: FLDataset, eval_n: int = 512
              ) -> RunDraws:
    """`RunDraws` for `ds` from `gen` (a torch.Generator or an integer
    seed), on the dataset's device and in its dtype: the parameters first,
    then the eval set."""
    gen = _generator(gen)
    dev, dt = ds.images.device, ds.images.dtype
    params = init_cnn(gen, num_classes=ds.num_classes, device=dev, dtype=dt)
    return RunDraws(params=params,
                    eval=eval_draws(gen, eval_n, ds.num_classes,
                                    ds.base_resolution, device=dev,
                                    dtype=dt))


@dataclasses.dataclass
class FLRunResult:
    params: Params
    round_accuracy: List[float]
    round_loss: List[float]


def run_federated(draws, ds: FLDataset, resolutions: Sequence[int],
                  global_rounds: int = 20, local_iters: int = 10,
                  lr: float = 0.05,
                  eval_every: int = 1, eval_n: int = 512,
                  eval_resolution: Optional[int] = None,
                  staleness=None, staleness_decay: float = 0.5
                  ) -> FLRunResult:
    """FedAvg over `ds` with per-client frame resolutions from the allocator.

    draws: a `RunDraws`, or a torch.Generator / integer seed that
        `run_draws` makes them from (with `eval_n` eval frames).
    resolutions: one rendering resolution per client (the allocator's s_n,
        mapped onto the dataset's resolution grid by the simulator).
    staleness: optional (global_rounds, n_clients) int array from the
        round-dynamics engine (`RoundsResult.staleness`): -1 = the client's
        update is lost this round (dropout / dropped straggler), 0 = arrives
        on time, k > 0 = arrives k rounds late with its FedAvg mass
        discounted by staleness_decay**k (late clients still train, from
        the global model of the round they started).
    """
    if not isinstance(draws, RunDraws):
        draws = run_draws(draws, ds, eval_n)
    params = draws.params
    ev_imgs, ev_labels = make_eval_set(draws.eval, ds)
    if isinstance(resolutions, Tensor):
        resolutions = resolutions.tolist()
    # MAR deployment serves at the frame resolution the fleet runs at:
    # eval at the median allocated resolution unless overridden
    ev_res = resolve_eval_resolution(eval_resolution, resolutions)
    ev_imgs = render(ev_imgs, ev_res)

    # pre-render each client's shard at its allocated resolution
    client_data = [(render(ds.images[i], int(resolutions[i])), ds.labels[i])
                   for i in range(ds.n_clients)]
    sizes = [float(ds.labels.shape[1])] * ds.n_clients

    accs: List[float] = []
    losses: List[float] = []
    if staleness is not None:
        staleness = np.asarray(staleness.cpu() if isinstance(
            staleness, Tensor) else staleness)
    total_w = float(sum(sizes))
    pending: dict = {}   # arrival round -> [(params, discounted weight)]
    for r in range(global_rounds):
        updated, weights, round_losses = [], [], []
        for i, (imgs, labels) in enumerate(client_data):
            code = 0 if staleness is None else int(staleness[r][i])
            if code < 0:   # update lost this round: no contribution
                continue
            if code > 0 and r + code >= global_rounds:
                continue   # would arrive after the run ends: skip the train
            p_i, loss_i = local_train(params, imgs, labels, lr, local_iters)
            round_losses.append(loss_i)
            if code == 0:
                updated.append(p_i)
                if staleness is not None:   # plain path weighs by sizes
                    weights.append(sizes[i])
            else:          # stale: arrives `code` rounds later, discounted
                w_eff = float(stale_weights(sizes[i], code, staleness_decay))
                pending.setdefault(r + code, []).append((p_i, w_eff))
        if staleness is None:
            params = fedavg(updated, sizes)
        else:
            arrivals = pending.pop(r, [])
            updated += [p for p, _ in arrivals]
            weights += [w for _, w in arrivals]
            params = fedavg_stale(params, updated, weights, total_w)
        round_losses = torch.stack(round_losses).tolist() \
            if round_losses else []
        losses.append(sum(round_losses) / len(round_losses)
                      if round_losses else float("nan"))
        if (r + 1) % eval_every == 0:
            accs.append(float(eval_accuracy(params, ev_imgs, ev_labels)))
    return FLRunResult(params=params, round_accuracy=accs, round_loss=losses)
