"""repro_torch.diff — differentiable allocation.

Port of `repro.diff`: implicit KKT gradients through the BCD fixed point
(`solve_and_grad`), weight auto-tuning against a latency target
(`tune_weights`), Pareto sweeps over the weight simplex (`pareto_sweep`),
and the learned accuracy surrogate (`fit_surrogate`, `fit_from_training`
from FedAvg training runs, `problem_with_surrogate`).
"""
from .implicit import DEFAULT_WRT, METRICS, GradResult, solve_and_grad
from .pareto import ParetoResult, pareto_front, pareto_sweep, weight_grid
from .surrogate import (FitDraws, SurrogateAccuracy, fit_from_training,
                        fit_surrogate, problem_with_surrogate)
from .tune import TuneResult, target_from_slos, tune_weights

__all__ = [
    "DEFAULT_WRT", "METRICS", "FitDraws", "GradResult", "ParetoResult",
    "SurrogateAccuracy", "TuneResult", "fit_from_training", "fit_surrogate",
    "pareto_front", "pareto_sweep", "problem_with_surrogate",
    "solve_and_grad", "target_from_slos", "tune_weights", "weight_grid",
]
