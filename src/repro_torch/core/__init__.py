"""repro_torch.core — the paper's model and Algorithm 2's solvers.

Port of `repro.core` (see `repro_torch/__init__.py` for what is ported).
"""
from .accuracy import (AccuracyModel, LinearAccuracy, LogAccuracy,
                       PowerAccuracy, default_accuracy, linear_from_endpoints,
                       log_fit, menu_of, system_with_menu)
from .bcd import (BCDResult, FleetResult, SolveCounters, initial_allocation,
                  stack_systems)
from .channel import expected_gain, make_fleet, make_system
from .energy import (feasible, objective, round_time, summarize,
                     total_accuracy, total_energy, total_time)
from .lambertw import lambertw0
from .sp1 import solve_sp1, solve_sp1_fixed_T
from .sp2 import (SP2Result, solve_sp2, solve_sp2_direct, solve_sp2_v2,
                  solve_sp2_v2_thm2)
from .types import (DEFAULTS, Allocation, SystemParams, Weights, dbm_to_watt,
                    resolve_device)

__all__ = [
    "AccuracyModel", "LinearAccuracy", "LogAccuracy", "PowerAccuracy",
    "default_accuracy", "linear_from_endpoints", "log_fit", "menu_of",
    "system_with_menu", "BCDResult", "FleetResult", "SolveCounters",
    "initial_allocation", "stack_systems", "expected_gain", "make_fleet",
    "make_system", "feasible", "objective", "round_time", "summarize",
    "total_accuracy", "total_energy", "total_time", "lambertw0",
    "solve_sp1", "solve_sp1_fixed_T", "SP2Result", "solve_sp2",
    "solve_sp2_direct", "solve_sp2_v2", "solve_sp2_v2_thm2", "DEFAULTS",
    "Allocation", "SystemParams", "Weights", "dbm_to_watt", "resolve_device",
]
