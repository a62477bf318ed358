"""Round-dynamics configuration and result types.

Port of `repro/dynamics/config.py`. `RoundsConfig` is a frozen dataclass
with the reference's fields, defaults and validation; `RoundsResult`
holds torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..core.types import Allocation

Tensor = torch.Tensor

# per-round ledger column order (one row per global round). sp2_evals is
# the round's SP2 dual-eval count from the solver's counters
# (`core.bcd._COUNTER_COLS`): warm-started rounds spend fewer evals than a
# cold re-solve.
ROUND_COLS = ("objective", "energy", "time", "accuracy", "arrived_frac",
              "n_late", "n_dropped", "bcd_iters", "bcd_converged",
              "sp2_evals")

_CHANNEL_MODES = ("static", "iid", "markov")
_PARTICIPATION_MODES = ("full", "drop", "stale")


@dataclasses.dataclass(frozen=True)
class RoundsConfig:
    """Configuration of the round engine (see `dynamics.engine`).

    channel_mode:
        "static" — every round sees the expected gain E[G_n] (the paper's
        Jensen setting; reproduces the allocate-once ledger),
        "iid"    — fresh lognormal shadowing per round (`sample_gain`),
        "markov" — AR(1) Gauss-Markov shadowing drift (`drift_shadowing`),
        round-to-round correlation `drift_rho`.
    participation:
        "full"  — every active device's update aggregates this round,
        "drop"  — deadline misses (realized makespan > deadline_slack * T)
        are discarded,
        "stale" — deadline misses arrive k rounds later with FedAvg mass
        discounted by staleness_decay**k (k <= max_staleness).
    dropout_prob: iid probability a device sits a round out entirely
        (no training, no energy spent, no update).
    bcd_iters: warm-started BCD iterations per round; 0 disables
        re-allocation (pure simulation of the init allocation, which must
        then carry a makespan T for the straggler deadline).
    warm_start: False re-solves from the paper's cold init every round
        (the ablation baseline).
    """
    rounds: int = 10
    # channel dynamics
    channel_mode: str = "static"
    shadowing_db: float = 8.0
    drift_rho: float = 0.9
    # warm-started per-round re-allocation
    bcd_iters: int = 8
    bcd_tol: float = 1e-6
    warm_start: bool = True
    sp1_method: str = "sweep"
    sp2_method: str = "direct"
    sp2_iters: int = 30
    # participation model
    participation: str = "full"
    dropout_prob: float = 0.0
    deadline_slack: float = 1.0
    max_staleness: int = 4
    staleness_decay: float = 0.5

    def __post_init__(self):
        if self.channel_mode not in _CHANNEL_MODES:
            raise ValueError(f"channel_mode must be one of {_CHANNEL_MODES}")
        if self.participation not in _PARTICIPATION_MODES:
            raise ValueError(
                f"participation must be one of {_PARTICIPATION_MODES}")
        if self.rounds < 1:
            raise ValueError("rounds must be >= 1")
        if self.max_staleness < 1:
            raise ValueError("max_staleness must be >= 1")
        if not 0.0 <= self.drift_rho <= 1.0:
            raise ValueError("drift_rho must be in [0, 1] (AR(1) stability)")
        if not 0.0 <= self.dropout_prob < 1.0:
            raise ValueError("dropout_prob must be in [0, 1)")
        if not 0.0 < self.staleness_decay <= 1.0:
            raise ValueError("staleness_decay must be in (0, 1]")
        if self.deadline_slack <= 0.0:
            raise ValueError("deadline_slack must be positive")
        if self.bcd_iters == 0 and not self.warm_start:
            # nothing would ever be solved: the engine would simulate the
            # paper cold init (T=0) forever, deadline 0, everything late
            raise ValueError("bcd_iters=0 requires warm_start=True "
                             "(it simulates the carried init allocation)")


@dataclasses.dataclass
class RoundsResult:
    """Output of a rounds solve: leading axis R for one cell, (C, R) for a
    fleet.

    allocation: the final round's Allocation, (N,) tensors (fleet: (C, N)).
    ledger:     (R, len(ROUND_COLS)) per-round values (fleet: (C, R, cols)).
    staleness:  (R, N) int32 per-device participation code: -1 = update lost
                (dropout, or deadline miss in "drop" mode), 0 = arrived on
                time, k > 0 = arrives k rounds late ("stale" mode).
    gains:      (R, N) realized channel gains each round.
    resolutions: (R, N) per-round allocated frame resolutions s_n.
    """
    allocation: Allocation
    ledger: Tensor
    staleness: Tensor
    gains: Tensor
    resolutions: Tensor
    columns: tuple = ROUND_COLS

    def col(self, name: str) -> Tensor:
        return self.ledger[..., self.columns.index(name)]

    def totals(self) -> Dict[str, float]:
        """Aggregate energy/time ledger (single-cell results only)."""
        if self.ledger.ndim != 2:
            raise ValueError(
                "totals() is per-cell: index a fleet result's leading cell "
                "axis first (ledger has shape "
                f"{tuple(self.ledger.shape)})")
        e, t = self.col("energy"), self.col("time")
        return dict(
            energy_total_J=float(e.sum()),
            time_total_s=float(t.sum()),
            energy_per_round_J=float(e.mean()),
            time_per_round_s=float(t.mean()),
            mean_arrived_frac=float(self.col("arrived_frac").mean()),
            rounds_converged=int((self.col("bcd_converged") > 0).sum()),
        )
