"""The system under test: `repro_torch.solve`, and nothing else of the port.

Each function takes the benchmark's own inputs (a reference `System` and
its weights), hands them to the port as its public types, and returns the
port's answer as plain tensors under the names the comparison reads.
"""
from __future__ import annotations

import torch

from reference.alg2 import ARRAYS, SCALARS, System


def port():
    """The port's package, imported on first use (it is not on the path
    until the harness has put the checkout's `src/` there)."""
    import repro_torch
    return repro_torch


def system_params(sys: System):
    """The port's `SystemParams` over the same tensors."""
    rt = port()
    return rt.SystemParams(**{k: getattr(sys, k) for k in ARRAYS + SCALARS},
                           resolutions=sys.resolutions)


def spec(max_iters: int):
    return port().SolverSpec(max_iters=max_iters)


def free_problem(sys: System, w):
    rt = port()
    return rt.Problem(system=system_params(sys), weights=rt.Weights(*w))


def fleet_answer(res) -> dict:
    """A `FleetResult` as the tensors the comparison reads: (C, N)
    allocation, (C,) T, objective, iterations and SP2 evaluations."""
    a = res.allocation
    return dict(B=a.bandwidth, p=a.power, f=a.freq, s=a.resolution,
                T=a.T.reshape(-1), objective=res.objective,
                iters=res.iters, sp2_evals=res.counters.sp2_evals)


def fleet_stats(answer: dict) -> torch.Tensor:
    """(2, 1) of a `fleet_answer`: its batched BCD iterations (the most any
    cell ran) and its mean SP2 evaluations over the cells."""
    return torch.stack([answer["iters"].double().amax(),
                        answer["sp2_evals"].double().mean()])[:, None]


def host_reads() -> int:
    from repro_torch.core.loops import while_cells
    return while_cells.host_reads
