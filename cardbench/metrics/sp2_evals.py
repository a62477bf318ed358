"""sp2_evals (evals): SP2's dE/dB evaluations of each allocation
(`FleetResult.counters` sp2_evals; a round's sp2_evals ledger column), the
mean over the fleet's cells, averaged over the window's allocations.
Layer: core/sp2.py. Moves alloc_s: SP2's direct search does most of a
solve's work."""


def read(run):
    v = run.sp2_evals
    return sum(v) / len(v) if v else None
