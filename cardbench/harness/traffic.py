"""The one traffic generator. A mix (`traffic/<mix>.json`) is data: the
`kind` of work it sends (`kinds/<kind>.py`), its weights, the size of its
pool, the seed of the pool's draws, and whatever else its kind reads. The
generator draws the pool of independent fleets on the device and hands it
to the kind, which defines one unit of work: the call a closed-loop caller
sends when its last answer is back.

Every seed gets the same work, laid out anew. How long a solve takes
depends on its data (a fleet whose slowest cell needs one more BCD
iteration costs a fifth more), so the pool's fleets are drawn from the
mix's `pool_seed`, and the run's seed permutes the cells of each fleet:
the same cell problems, laid out and sampled differently. The fleets keep
their order, so that a traced run always traces the same fleet's call. A
cell's devices keep their order: summed in another order, a cell near a
convergence test can take one iteration more. The window ends on a whole
pass over the pool.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch

from harness import fleet, spec
from reference.alg2 import System

@dataclasses.dataclass
class Workload:
    cfg: dict
    mix: dict
    kind: object                      # the mix's `kinds/<kind>.py`
    pool: List[System]
    call: Callable[[System], dict]    # one unit of work -> the answer


def shuffled(pool: List[System], gen: torch.Generator) -> List[System]:
    """Each fleet of the pool with its cells permuted by the seed."""
    return [s.rows(torch.randperm(s.gain.shape[0], generator=gen,
                                  device=s.gain.device)) for s in pool]


def build(cfg: dict, mix: dict, seed: int, device) -> Workload:
    """The pool and the unit of work of one cell: the mix's fleets in the
    seed's layout."""
    base = fleet.generator(int(mix["pool_seed"]), device)
    pool = fleet.draw(cfg, int(mix["pool"]), base, device,
                      getattr(torch, cfg["dtype"]))
    pool = shuffled(pool, fleet.generator(seed, device))
    kind = spec.kind(mix["kind"])
    return Workload(cfg=cfg, mix=mix, kind=kind, pool=pool,
                    call=kind.call(cfg, mix, pool))
