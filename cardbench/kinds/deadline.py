"""Kind `deadline`: energy under per-cell deadlines (the paper's Figs.
8-9), one fleet of the pool a call. Set-up works out each cell's deadline
as `deadline_slack` x the total time of the port's free solve of its fleet
under `free_weights`; a call solves the fleet for the least energy under
the mix's `weights` within those deadlines. The reference works its own
deadlines out again from its own free solve, and the check compares them
with the program's. The interface is `kinds/free.py`'s.
"""
from __future__ import annotations

import torch

from harness import check, program
from reference import alg2


def call(cfg: dict, mix: dict, pool: list):
    from repro_torch.core.energy import total_time

    rt = program.port()
    spec = program.spec(int(cfg["max_iters"]))
    slack = float(mix["deadline_slack"])
    deadlines = {}
    for sys in pool:
        res = rt.solve(program.free_problem(sys, mix["free_weights"]), spec)
        deadlines[id(sys)] = slack * total_time(program.system_params(sys),
                                                res.allocation)[:, 0]
    w = rt.Weights(*mix["weights"])

    def one(sys):
        d = deadlines[id(sys)]
        res = rt.solve(rt.Problem(system=program.system_params(sys),
                                  weights=w, deadline=d), spec)
        return dict(program.fleet_answer(res), deadline=d)
    return one


stats = program.fleet_stats


def reference(sys, cfg: dict, mix: dict, dtype) -> dict:
    sys = sys.to(dtype=dtype)
    max_iters, tol = int(cfg["max_iters"]), check.effective_tol(cfg)
    free = alg2.free(sys, tuple(mix["free_weights"]), max_iters, tol)
    _, T, _ = alg2.totals(sys, free["B"], free["p"], free["f"], free["s"])
    d = float(mix["deadline_slack"]) * T
    r = alg2.deadline(sys, tuple(mix["weights"]), d, max_iters, tol)
    return dict(B=r["B"], p=r["p"], f=r["f"], s=r["s"], T=r["T"][:, 0],
                objective=r["objective"][:, 0], deadline=d[:, 0],
                iters=r["iters"],
                sp2_evals=torch.zeros_like(r["objective"][:, 0]))


def gaps(prog: dict, ref: dict, sys, mix: dict) -> dict:
    """objective: the largest |E - E_ref| / E_ref, E the energy of the
    program's allocation, worked out by the reference's arithmetic in
    float64; deadline: the largest relative gap of a cell's deadline as
    set-up derived it; budget, bandwidth, power, freq, resolution as in
    `kinds/free.py`."""
    f64 = sys.to(dtype=torch.float64)
    E, _, _ = alg2.totals(f64, *(prog[k].double() for k in "Bpfs"))
    total = f64.bandwidth_total[:, 0]
    return dict(
        objective=check.worst(check.rel(E[:, 0], ref["objective"])),
        deadline=check.worst(check.rel(prog["deadline"], ref["deadline"])),
        budget=check.worst((prog["B"].double().sum(-1) - total) / total),
        bandwidth=check.typical(check.rel_l2(prog["B"], ref["B"])),
        power=check.typical(check.rel_l2(prog["p"], ref["p"])),
        freq=check.typical(check.rel_l2(prog["f"], ref["f"])),
        resolution=float((prog["s"].double() != ref["s"].double())
                         .double().mean()))
