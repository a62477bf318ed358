"""repro_torch.dynamics — the FL round-dynamics engine.

Port of `repro.dynamics`. R global rounds of sampled channel gains (iid or
AR(1) Gauss-Markov drift), warm-started BCD re-allocation, and a
straggler / dropout / async-staleness participation model, with the
realized energy / time / accuracy ledger; entered through
`repro_torch.solve(Problem(rounds=RoundsConfig(...), key=...))`.

Public API:
    RoundsConfig, RoundsResult, ROUND_COLS   configuration / result types
    RoundDraws, draws_from_generator         the engine's random inputs
    staleness_of, queue_step                 participation-model primitives
    MobilityConfig, MobilityTrace,           mobility traces (RWP /
    MobilityDraws, simulate_mobility,        Gauss-Markov) and their gains
    trace_gains
    replay_mobility                          a trace driven through the
                                             region serving front-end

Not ported: the deprecated shims `run_rounds` / `run_rounds_fleet` (use
`solve`).
"""
from .config import ROUND_COLS, RoundsConfig, RoundsResult
from .engine import RoundDraws, draws_from_generator
from .mobility import (MobilityConfig, MobilityDraws, MobilityTrace,
                       mobility_draws, replay_mobility, simulate_mobility,
                       trace_gains)
from .participation import queue_step, staleness_of

__all__ = ["ROUND_COLS", "RoundsConfig", "RoundsResult", "RoundDraws",
           "draws_from_generator", "queue_step", "staleness_of",
           "MobilityConfig", "MobilityDraws", "MobilityTrace",
           "mobility_draws", "replay_mobility", "simulate_mobility",
           "trace_gains"]
