"""repro_torch — FL-MAR resource allocation in PyTorch, for NVIDIA Hopper.

The port of `repro` (the JAX package beside it, which stays the reference):

    from repro_torch import Problem, SolverSpec, Weights, make_system, solve

    sys_ = make_system(0, n_devices=50)            # on CUDA by default
    res = solve(Problem(system=sys_, weights=Weights(0.5, 0.5, 1.0)),
                SolverSpec(max_iters=8))

Ported so far: the paper's Algorithm 2 through `solve` with every engine
of `SolverSpec` (SP1 "sweep" or "bisect", SP2 "direct" or the paper's
Algorithm 1 "jong") and any concave accuracy model, for one cell and for
a stacked (C, N) fleet, which runs every cell in one batch; the
deadline-constrained variant (`Problem.deadline`, scalar or per cell);
the paper-literal Theorem-2 SP2 solve (`core.sp2.solve_sp2_v2_thm2`) and
the paper's baselines (`core.baselines`); and LM serving
(`launch.serve`, `models`, `configs`) for dense GQA and RWKV6 models.
Four hand-written CUDA kernels, built with nvcc at first use: the dual
sweeps of SP1 (`sp1_lambda_sum`, `kernels/csrc/sp1_sweep.cu`) and of
Theorem 2 (`waterfill_gprime`, `kernels/csrc/waterfill.cu`), and the
prefill's attention (`flash_attention`) and RWKV6 scan (`rwkv6_scan`). Entry points build on CUDA unless the caller asks
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
