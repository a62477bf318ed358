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
padding of mixed-size cell pools onto one bucket with masked lanes
(`region.batch`: `bucket_size`, `pad_system`, `inactive_system`,
`pad_allocation`); the FL round-dynamics engine (`Problem.rounds` with a
`dynamics.RoundsConfig`: sampled or Markov fading, warm-started
re-allocation, dropout and stale participation, its draws given as a
`RoundDraws` or drawn from a `torch.Generator`) and mobility traces
(`dynamics.simulate_mobility`, replayed through the serving front-end by
`dynamics.replay_mobility`); the region serving stack (`region`: the
admission -> planning -> dispatch -> completion `RegionPipeline`, its
synchronous facade `RegionAllocator`, and `Problem.mesh` with
`region_mesh` and `SolverSpec.lockstep`); telemetry (`obs`: spans and
points, the metric registry and its Prometheus / JSONL exporters, SLO
burn rates, the `MetricsServer` scrape endpoint, torch.profiler
sessions); implicit gradients of the allocation
(`diff.solve_and_grad`, with `diff.tune_weights`, `diff.pareto_sweep` and
the learned accuracy surrogate); the paper-literal Theorem-2 SP2 solve
(`core.sp2.solve_sp2_v2_thm2`) and the paper's baselines
(`core.baselines`); and LM serving (`launch.serve`, `models`, `configs`)
for dense GQA, RWKV6, Mamba and MoE models. Five hand-written CUDA
kernels, built with nvcc at first use: the dual sweeps of SP1
(`sp1_lambda_sum`, `kernels/csrc/sp1_sweep.cu`) and of Theorem 2
(`waterfill_gprime`, `kernels/csrc/waterfill.cu`), and the prefill's
attention (`flash_attention`), RWKV6 scan (`rwkv6_scan`) and Mamba scan
(`mamba_scan`). Entry points build on CUDA unless the caller asks for
`device="cpu"`; `solve` runs on the device of the system's tensors. The
module layout mirrors `repro` file for file; this package imports neither
JAX nor `repro`.
"""
from .api import (Problem, SolverSpec, TolFloorWarning, WeightsLike,
                  rel_step_floor, solve, weights_leaf)
from .core import (AccuracyModel, Allocation, BCDResult, FleetResult,
                   SystemParams, Weights, default_accuracy, make_fleet,
                   make_system, stack_systems)
from .diff import GradResult, solve_and_grad
from .dynamics import (MobilityConfig, MobilityTrace, RoundDraws,
                       RoundsConfig, RoundsResult, replay_mobility,
                       simulate_mobility)
from .region import (AllocationRequest, CellResponse, CloseOnFull,
                     DeadlineSlack, MaxWait, PendingResponse,
                     RegionAllocator, RegionPipeline, RegionResult,
                     StageClocks, bucket_size, inactive_system, pad_system,
                     region_mesh)
from . import obs

__all__ = [
    "Problem", "SolverSpec", "TolFloorWarning", "WeightsLike",
    "rel_step_floor", "solve", "weights_leaf",
    "AccuracyModel", "Allocation", "BCDResult", "FleetResult",
    "SystemParams", "Weights", "default_accuracy", "make_fleet",
    "make_system", "stack_systems",
    "GradResult", "solve_and_grad",
    "MobilityConfig", "MobilityTrace", "RoundDraws", "RoundsConfig",
    "RoundsResult", "replay_mobility", "simulate_mobility",
    "bucket_size", "inactive_system", "pad_system",
    "AllocationRequest", "CellResponse", "CloseOnFull", "DeadlineSlack",
    "MaxWait", "PendingResponse", "RegionAllocator", "RegionPipeline",
    "RegionResult", "StageClocks", "region_mesh", "obs",
]
