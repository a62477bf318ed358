"""bcd_iters (iters): the batched BCD iterations of each allocation, the
most any cell of the fleet ran (`FleetResult.iters`; a round's
`bcd_iters` ledger column), averaged over the window's allocations.
Layer: core/bcd.py. Moves alloc_s: a batched iteration is one SP1 and one
SP2 pass over every cell."""


def read(run):
    v = run.batched_iters
    return sum(v) / len(v) if v else None
