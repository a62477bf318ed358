"""Configuration / result types for cross-cell user association.

Port of `repro/assoc/config.py` (pure numpy, copied as it is).

`AssocConfig` is frozen and hashable (like `SolverSpec` /
`dynamics.RoundsConfig`): setting `Problem.assoc = AssocConfig(...)`
routes the one `solve()` dispatcher to the BCD-over-association outer
loop (`assoc.loop.solve_assoc`). The knobs configure the *outer* loop
only — the inner per-cell resource solves keep taking everything from
`SolverSpec`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class AssocConfig:
    """Knobs of the BCD-over-association outer loop.

    outer_iters : max association steps. Each step proposes a greedy
        capacity-capped reassignment from the current marginal costs,
        re-solves the per-cell resources, and accepts only if the global
        weighted objective improves (so the realized objective is
        non-increasing by construction). 0 = solve the initial (static
        nearest-cell) association once and stop — the baseline.
    capacity : per-cell device cap — an int (every cell), a length-C tuple
        (per cell), or None (uncapped). The summed capacity must cover
        every active device.
    warm_start : warm-start each outer re-solve from the previous
        allocations (moved devices restart from the cold init values of
        their new cell; stayers keep their solution). False = every outer
        solve is cold — bit-reproducible from the assignment alone.
    """
    outer_iters: int = 8
    capacity: Optional[Union[int, Tuple[int, ...]]] = None
    warm_start: bool = True

    def __post_init__(self):
        if self.outer_iters < 0:
            raise ValueError("AssocConfig: outer_iters must be >= 0")
        cap = self.capacity
        if cap is None:
            return
        if isinstance(cap, (list, np.ndarray)):   # keep the dataclass hashable
            object.__setattr__(self, "capacity",
                               tuple(int(c) for c in np.asarray(cap)))
            cap = self.capacity
        caps = cap if isinstance(cap, tuple) else (cap,)
        if any(int(c) < 0 for c in caps):
            raise ValueError("AssocConfig: capacities must be >= 0")

    def per_cell_capacity(self, n_cells: int, n_devices: int) -> np.ndarray:
        """Resolve to an (C,) int array; None means 'fits everyone'."""
        if self.capacity is None:
            cap = np.full(n_cells, n_devices, dtype=np.int64)
        elif isinstance(self.capacity, tuple):
            if len(self.capacity) != n_cells:
                raise ValueError(
                    f"AssocConfig: {len(self.capacity)} capacities for "
                    f"{n_cells} cells")
            cap = np.asarray(self.capacity, dtype=np.int64)
        else:
            cap = np.full(n_cells, int(self.capacity), dtype=np.int64)
        return cap


@dataclasses.dataclass
class AssocResult:
    """Outcome of the association outer loop.

    `objectives[k]` is the accepted global weighted objective after the
    k-th accepted solve (index 0 = the initial association); the sequence
    is non-increasing by the accept/reject construction. `fleet` is the
    final accepted per-cell solve (a `FleetResult`, or a `RegionResult`
    when the problem carried a mesh) over the full (C, N) lanes — lane
    (c, n) is meaningful only where `assignment[n] == c`.
    """
    assignment: np.ndarray          # (N,) int32; -1 = inactive device
    fleet: object                   # FleetResult | RegionResult
    objective: float                # final accepted global objective
    objectives: List[float]         # per accepted solve, non-increasing
    moves: List[int]                # devices moved by each accepted step
    outer_iters: int                # association steps attempted
    converged: bool                 # reached a fixed point before the cap
