"""Federated LM fine-tuning driven by the allocator.

Port of the flow of `examples/fedavg_lm.py`. Each FL client trains a
shared LM locally; the paper's allocator (Algorithm 2, `solve`) decides
each client's token budget (the LM analogue of the frame resolution s_n:
32 tokens per step of the resolution menu) and the wireless (p, B)
schedule from a system whose c_n is the architecture's FLOPs per sample
(`core.costmodel.arch_system`); FedAvg merges the clients' weights after
every round.

    PYTHONPATH=src python -m repro_torch.launch.fedavg_lm --device cpu

The train step updates parameters in place, so each client trains a
working copy of the model loaded from the global weights; the clients'
weights are summed into float32 buffers and the mean cast back, as the
example's `sum(l.astype(float32)).astype(dtype) / n` does.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..api import Problem, SolverSpec, solve
from ..configs import get_config
from ..configs.base import ModelConfig
from ..core.costmodel import arch_system
from ..core.energy import e_cmp, e_trans, round_time
from ..core.types import Weights, resolve_device
from ..data import SyntheticLM
from ..models.transformer import Model, init_model
from ..optim import SGD
from .steps import make_train_step

ARCH = "internlm2-20b"
N_CLIENTS, ROUNDS, LOCAL_STEPS = 4, 5, 3
BATCH, LR = 4, 0.3          # sequences a local step, SGD's step size
WEIGHTS = (0.5, 0.5, 3e4)
SPEC = dict(max_iters=4)
TOKENS_PER_LEVEL = 32


@dataclasses.dataclass
class Allocated:
    """The allocation step's outputs: the solve's result, each client's
    token budget and the fleet energy / round makespan."""
    result: object
    budgets: List[int]
    energy_per_round: float
    makespan: float


def token_budgets(system, resolution: torch.Tensor) -> List[int]:
    """32 x (1 + the index of each client's s_n on the resolution menu)."""
    grid = list(system.resolutions)
    return [TOKENS_PER_LEVEL * (1 + grid.index(float(s)))
            for s in resolution.reshape(-1).tolist()]


def allocate(system) -> Allocated:
    """Algorithm 2 on `system` (the example's WEIGHTS and SPEC), then the
    clients' token budgets and, from the allocation, the fleet energy of
    one round (sum of e_trans + e_cmp) and the round makespan."""
    res = solve(Problem(system=system, weights=Weights(*WEIGHTS)),
                SolverSpec(**SPEC))
    a = res.allocation
    energy = float(torch.sum(e_trans(system, a.bandwidth, a.power)
                             + e_cmp(system, a.freq, a.resolution)))
    return Allocated(result=res,
                     budgets=token_budgets(system, a.resolution),
                     energy_per_round=energy,
                     makespan=float(round_time(system, a).reshape(-1)[0]))


@torch.no_grad()
def fedavg(model: Model, clients: Sequence[Dict[str, torch.Tensor]]):
    """model's parameters <- the clients' mean with equal weights: summed
    in float32 in client order, cast back to each parameter's dtype, then
    divided by the client count. In place."""
    for name, p in model.named_parameters():
        acc = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for c in clients:
            acc += c[name].float()
        p.copy_(acc.to(p.dtype) / len(clients))


def train_rounds(model: Model, cfg: ModelConfig, budgets: Sequence[int], *,
                 rounds: int = ROUNDS, local_steps: int = LOCAL_STEPS,
                 on_round: Optional[Callable] = None) -> List[List[float]]:
    """FedAvg rounds from `model`'s weights (updated in place): every
    round, each client starts from the global weights, takes
    `local_steps` SGD steps on its own `SyntheticLM` stream (seeded by its
    index) cut to its budget, and the clients' weights are averaged.
    Returns each round's client losses (the last local step's).
    on_round(r, model, clients), if given, sees each round's client
    weights (name -> tensor) and the averaged model."""
    device = next(model.parameters()).device
    opt = SGD(lr=LR)
    step, _ = make_train_step(cfg, opt)
    streams = [iter(SyntheticLM(cfg.vocab_size, BATCH, max(budgets), seed=i))
               for i in range(len(budgets))]
    work = copy.deepcopy(model)
    losses = []
    for r in range(rounds):
        clients, round_losses = [], []
        for c, budget in enumerate(budgets):
            with torch.no_grad():
                for w, g in zip(work.parameters(), model.parameters()):
                    w.copy_(g)
            state = opt.init(dict(work.named_parameters()))
            for _ in range(local_steps):
                toks = next(streams[c])["tokens"][:, :budget]
                b = {"tokens": torch.from_numpy(toks).to(device).long()}
                _, state, m = step(work, state, b)
            round_losses.append(float(m["loss"]))
            clients.append({n: p.detach().clone()
                            for n, p in work.named_parameters()})
        fedavg(model, clients)
        if on_round is not None:
            on_round(r, model, clients)
        losses.append(round_losses)
        del clients
    for p in model.parameters():
        p.requires_grad_(False)
    return losses


def main(argv=None):
    """The example's flow, with its constants: allocate for internlm2-20b
    (c_n from the whole config) over N_CLIENTS clients, then train the
    reduced internlm2-20b by FedAvg at the allocated budgets for ROUNDS
    rounds of LOCAL_STEPS local steps. Returns each round's client
    losses."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(ARCH).reduced()
    system = arch_system(0, ARCH, n_devices=N_CLIENTS, device=device)
    al = allocate(system)
    print("per-client token budgets (from allocated s_n):", al.budgets)
    model = init_model(cfg, 0, device)
    losses = train_rounds(model, cfg, al.budgets, rounds=ROUNDS,
                          local_steps=LOCAL_STEPS)
    for r, ls in enumerate(losses):
        print(f"round {r + 1}: client losses {[round(x, 3) for x in ls]}")
    energy = al.energy_per_round * ROUNDS
    print(f"simulated fleet energy for {ROUNDS} rounds: {energy:.4g} J;"
          f" round makespan {al.makespan:.3f} s")
    return losses


if __name__ == "__main__":
    main()
