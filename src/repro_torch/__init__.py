"""repro_torch — FL-MAR resource allocation in PyTorch, for NVIDIA Hopper.

The port of `repro` (the JAX package beside it, which stays the reference):

    from repro_torch import Problem, SolverSpec, Weights, make_system, solve

    sys_ = make_system(0, n_devices=50)            # on CUDA by default
    res = solve(Problem(system=sys_, weights=Weights(0.5, 0.5, 1.0)),
                SolverSpec(max_iters=8))

Ported so far: the paper's Algorithm 2 through `solve` with the default
spec (SP1 "sweep" over LinearAccuracy, SP2 "direct"), for one cell and for
a stacked (C, N) fleet, which runs every cell in one batch. SP1's dual
sweep is a hand-written CUDA kernel (`kernels/csrc/sp1_sweep.cu`), built
with nvcc at first use. Entry points build on CUDA unless the caller asks
for `device="cpu"`; `solve` runs on the device of the system's tensors.
The module layout mirrors `repro` file for file; this package imports
neither JAX nor `repro`.
"""
from .api import (Problem, SolverSpec, TolFloorWarning, WeightsLike,
                  rel_step_floor, solve, weights_leaf)
from .core import (AccuracyModel, Allocation, BCDResult, FleetResult,
                   SystemParams, Weights, default_accuracy, make_fleet,
                   make_system, stack_systems)

__all__ = [
    "Problem", "SolverSpec", "TolFloorWarning", "WeightsLike",
    "rel_step_floor", "solve", "weights_leaf",
    "AccuracyModel", "Allocation", "BCDResult", "FleetResult",
    "SystemParams", "Weights", "default_accuracy", "make_fleet",
    "make_system", "stack_systems",
]
