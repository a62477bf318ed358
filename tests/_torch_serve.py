"""Shared helpers of the region serving parity tests: the same request
traces built for `repro.region` and for `repro_torch.region` (the port's
systems carried over from the reference's through `interop`), and the
comparisons of their responses and serving tallies."""
import jax
import numpy as np

import repro
from repro.region import AllocationRequest as AllocationRequest_j

import repro_torch as rt

from _torch_rounds import EV_SLACK_PER_ITER, to_port

# float64 responses, port vs repro: objectives relative, allocations
# relative to each field's largest value (measured: <= 4e-15 and <= 4e-13
# on these traces)
OBJ_TOL, ALLOC_TOL = 1e-9, 1e-9
FIELDS = ("bandwidth", "power", "freq", "resolution")


def system_j(cell_id, n, seed=None, drift=0.0):
    """The reference's request system for `cell_id`: make_system from
    PRNGKey(seed, default 100 + a stable function of the id), gains
    scaled by 1 + drift."""
    if seed is None:
        seed = 100 + (cell_id if isinstance(cell_id, int)
                      else sum(map(ord, str(cell_id))) % 1000)
    sysp = repro.make_system(jax.random.PRNGKey(seed), n_devices=n)
    if drift:
        sysp = sysp.replace(gain=sysp.gain * (1.0 + drift))
    return sysp


def requests(cell_id, n, seed=None, drift=0.0, **kw):
    """(reference request, port request) over the same system."""
    sj = system_j(cell_id, n, seed, drift)
    w = kw.pop("w", None)
    wj = None if w is None else repro.Weights(*w)
    wt = None if w is None else rt.Weights(*w)
    return (AllocationRequest_j(cell_id=cell_id, sys=sj, w=wj, **kw),
            rt.AllocationRequest(cell_id=cell_id, sys=to_port(sj), w=wt,
                                 **kw))


def same_response(rj, rt_, obj_tol=OBJ_TOL, alloc_tol=ALLOC_TOL):
    """A reference CellResponse and the port's agree: the same cell,
    iterations, convergence, warm flag and bucket; the objective and the
    allocation within the tolerances."""
    assert (rt_.cell_id, rt_.iters, rt_.converged, rt_.warm, rt_.bucket) \
        == (rj.cell_id, rj.iters, rj.converged, rj.warm, rj.bucket)
    assert abs(rt_.objective - rj.objective) <= obj_tol * abs(rj.objective)
    for f in FIELDS:
        a = getattr(rt_.allocation, f).numpy()
        b = np.asarray(getattr(rj.allocation, f))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= alloc_tol * np.abs(b).max(), f


def same_stats(sj, st):
    """The serving tallies agree; the summed SP2 evals within the
    per-iteration slack (ROADMAP Queue 3)."""
    keys = ("requests", "batches", "cache_hits", "cache_misses",
            "cells_padded", "handover_purges", "shapes", "cells_solved",
            "cells_converged", "deadline_hits", "deadline_requests")
    assert {k: st[k] for k in keys} == {k: sj[k] for k in keys}
    cj, ct = sj["solver_counters"], st["solver_counters"]
    assert set(ct) == set(cj)
    assert ct["bcd_iters"] == cj["bcd_iters"]
    assert ct["sp1_evals"] == cj["sp1_evals"]
    assert abs(ct["sp2_evals"] - cj["sp2_evals"]) \
        <= EV_SLACK_PER_ITER * cj["bcd_iters"]
