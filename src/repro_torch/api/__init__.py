"""repro_torch.api — the solver API: one `solve()`, one `SolverSpec`.

Port of `repro.api`.
"""
from .problem import Problem, WeightsLike, weights_leaf
from .solve import solve
from .spec import (REL_STEP_FLOOR_ULPS, SolverSpec, TolFloorWarning,
                   rel_step_floor)

__all__ = ["Problem", "SolverSpec", "TolFloorWarning", "WeightsLike",
           "solve", "weights_leaf", "REL_STEP_FLOOR_ULPS", "rel_step_floor"]
