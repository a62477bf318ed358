"""repro_torch.assoc — cross-cell user association (BCD-over-association).

Port of `repro.assoc`. The multi-cell scenario axis (arXiv:2212.08324 /
2301.12085): devices pick their serving cell. An association step
(greedy marginal-cost cell choice under per-cell capacity caps, on the
host) alternates with per-cell resource re-solves through the one
`solve()` dispatcher, every cell in one batch on the device; a stacked
(C, N) system plus `Problem.assoc = AssocConfig(...)` routes it.

Public API:
    AssocConfig, AssocResult        outer-loop knobs / outcome
    solve_assoc                     the outer loop (direct entry; `solve`
                                    delegates here on Problem.assoc)
    nearest_assignment              the static strongest-gain baseline
    make_multicell, bs_grid,        shared-geometry scenario builders
    cross_gains
"""
from .config import AssocConfig, AssocResult
from .loop import (greedy_assign, marginal_costs, nearest_assignment,
                   solve_assoc)
from .scenario import bs_grid, cross_gains, make_multicell

__all__ = ["AssocConfig", "AssocResult", "solve_assoc",
           "nearest_assignment", "greedy_assign", "marginal_costs",
           "bs_grid", "cross_gains", "make_multicell"]
