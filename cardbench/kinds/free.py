"""Kind `free`: cold free solves of whole fleets (Algorithm 2 under the
mix's weights), one fleet of the pool a call. What a kind module gives the
harness:

  call(cfg, mix, pool)   the unit of work, a function of one pool fleet
                         returning the program's answer as plain tensors
                         (each with the cell axis first) that hold at least
                         `iters` and `sp2_evals` of each cell
  stats(answer)          (2, allocations): each allocation's batched BCD
                         iterations and mean SP2 evaluations over the cells
  reference(sys, cfg, mix, dtype)
                         the reference's answer for the fleet `sys` (rows
                         of a pool fleet), computed in `dtype`, under the
                         same names as the program's
  gaps(prog, ref, sys, mix)
                         every number the check can compare, from the
                         program's answer and the float64 reference's
"""
from __future__ import annotations

import torch

from harness import check, program
from reference import alg2


def call(cfg: dict, mix: dict, pool: list):
    spec = program.spec(int(cfg["max_iters"]))
    w = tuple(mix["weights"])
    solve = program.port().solve

    def one(sys):
        return program.fleet_answer(solve(program.free_problem(sys, w),
                                          spec))
    return one


stats = program.fleet_stats


def reference(sys, cfg: dict, mix: dict, dtype) -> dict:
    r = alg2.free(sys.to(dtype=dtype), tuple(mix["weights"]),
                  int(cfg["max_iters"]), check.effective_tol(cfg))
    return dict(B=r["B"], p=r["p"], f=r["f"], s=r["s"], T=r["T"][:, 0],
                objective=r["objective"][:, 0], iters=r["iters"],
                sp2_evals=torch.zeros_like(r["objective"][:, 0]))


def gaps(prog: dict, ref: dict, sys, mix: dict) -> dict:
    """objective: the largest |J - J_ref| over (w1 E + w2 T + rho A)_ref,
    J the objective of the program's allocation, worked out by the
    reference's arithmetic in float64;
    budget: the largest (sum_n B_n - B_total) / B_total; bandwidth, power,
    freq: the median over cells of a cell's relative L2 gap; T: the median
    relative gap; resolution: the share of devices whose resolution
    differs."""
    f64 = sys.to(dtype=torch.float64)
    w = alg2.weights(tuple(mix["weights"]), f64.gain.shape[0], f64.gain)
    scale = alg2.objective_scale(f64, w, *(ref[k].double()
                                           for k in "Bpfs"))[:, 0]
    J = alg2.objective(f64, w, *(prog[k].double() for k in "Bpfs"))[:, 0]
    total = f64.bandwidth_total[:, 0]
    return dict(
        objective=check.worst((J - ref["objective"].double()).abs()
                              / scale),
        budget=check.worst((prog["B"].double().sum(-1) - total) / total),
        bandwidth=check.typical(check.rel_l2(prog["B"], ref["B"])),
        power=check.typical(check.rel_l2(prog["p"], ref["p"])),
        freq=check.typical(check.rel_l2(prog["f"], ref["f"])),
        T=check.typical(check.rel(prog["T"], ref["T"])),
        resolution=float((prog["s"].double() != ref["s"].double())
                         .double().mean()))
