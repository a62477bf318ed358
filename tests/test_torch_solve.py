"""`repro_torch.solve` (Algorithm 2 end to end) against `repro.solve` on
the same systems: the paper's single cell and a mixed-weight fleet, in
float64 and float32, on the CPU (where the SP1 kernel's plain version runs).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import repro
from repro.core.types import _SYS_ARRAYS, _SYS_SCALARS

import repro_torch as rt
from repro_torch import interop
from repro_torch.core.bcd import _LEDGER_COLS

# the SP2 dual search's eval count rides data-dependent exits, which XLA's
# fused arithmetic moves by a few evaluations per BCD iteration
# (ROADMAP.md Queue 3); every other counter and column must agree
EV_SLACK_PER_ITER = 8
FLOOR64 = rt.rel_step_floor(torch.float64)
MIXED = [(0.5, 0.5, 1.0), (0.9, 0.1, 1.0), (0.2, 0.8, 0.5), (0.0, 1.0, 1.0)]


def to_port(sysj):
    leaves = {k: np.asarray(getattr(sysj, k)) for k in _SYS_ARRAYS + _SYS_SCALARS}
    return interop.system_from_numpy(leaves, sysj.resolutions, device="cpu")


@pytest.fixture(scope="module")
def paper_cell():
    sj = repro.make_system(jax.random.PRNGKey(0), n_devices=50)
    return sj, to_port(sj)


@pytest.fixture(scope="module")
def fleet():
    fj = repro.make_fleet(jax.random.PRNGKey(3), n_cells=4, n_devices=64,
                          bandwidth_total=20e6 * 64 / 50)
    return fj, to_port(fj)


def solve_both(sysj, syst, weights, **spec):
    if isinstance(weights, list):
        wj = [repro.Weights(*w) for w in weights]
        wt = [rt.Weights(*w) for w in weights]
    else:
        wj, wt = repro.Weights(*weights), rt.Weights(*weights)
    rj = repro.solve(repro.Problem(system=sysj, weights=wj),
                     repro.SolverSpec(**spec))
    rr = rt.solve(rt.Problem(system=syst, weights=wt), rt.SolverSpec(**spec))
    return rj, rr


@pytest.mark.parametrize("w", [(0.5, 0.5, 1.0), (0.0, 1.0, 1.0)])
def test_single_cell_f64_matches(paper_cell, w):
    rj, rr = solve_both(*paper_cell, w)
    assert isinstance(rr, rt.BCDResult)
    assert rr.iters == rj.iters and rr.converged == rj.converged
    assert rr.objective == pytest.approx(rj.objective, rel=1e-6)
    for hj, ht in zip(rj.history, rr.history):
        assert ht["iter"] == hj["iter"]
        for c in _LEDGER_COLS:
            if c == "sp2_iters":
                assert abs(ht[c] - hj[c]) <= EV_SLACK_PER_ITER
            elif c == "rel_step":   # below the floor, steps are noise
                assert ht[c] == pytest.approx(hj[c], rel=1e-6, abs=FLOOR64)
            else:
                assert ht[c] == pytest.approx(hj[c], rel=1e-6, abs=1e-300)
    cj, ct = rj.counters.as_dict(), rr.counters.as_dict()
    assert set(ct) == set(cj)
    for k in ("bcd_iters", "sp1_evals"):
        assert ct[k] == cj[k]
    assert ct["residual"] == pytest.approx(cj["residual"], rel=1e-6)
    assert abs(ct["sp2_evals"] - cj["sp2_evals"]) \
        <= EV_SLACK_PER_ITER * rj.iters
    a = rr.allocation
    assert a.bandwidth.shape == (50,) and a.T.shape == ()
    np.testing.assert_allclose(a.bandwidth.numpy(),
                               np.asarray(rj.allocation.bandwidth), rtol=1e-6)
    np.testing.assert_array_equal(a.resolution.numpy(),
                                  np.asarray(rj.allocation.resolution))
    assert rt.core.energy.feasible(paper_cell[1], a)


def test_fleet_mixed_weights_f64_matches(fleet):
    rj, rr = solve_both(*fleet, MIXED, max_iters=8)
    assert isinstance(rr, rt.FleetResult)
    np.testing.assert_allclose(rr.objective.numpy(), np.asarray(rj.objective),
                               rtol=1e-6)
    np.testing.assert_array_equal(rr.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_array_equal(rr.converged.numpy(),
                                  np.asarray(rj.converged))
    assert rr.history.shape == np.asarray(rj.history).shape
    hj, ht = np.asarray(rj.history), rr.history.numpy()
    np.testing.assert_array_equal(np.isnan(ht), np.isnan(hj))
    keep = [i for i, c in enumerate(_LEDGER_COLS)
            if c not in ("sp2_iters", "rel_step")]
    np.testing.assert_allclose(ht[..., keep], hj[..., keep], rtol=1e-6)
    rel = _LEDGER_COLS.index("rel_step")   # below the floor, steps are noise
    np.testing.assert_allclose(ht[..., rel], hj[..., rel], rtol=1e-6,
                               atol=FLOOR64)
    ev = np.nan_to_num(np.abs(ht[..., _LEDGER_COLS.index("sp2_iters")]
                              - hj[..., _LEDGER_COLS.index("sp2_iters")]))
    assert ev.max() <= EV_SLACK_PER_ITER
    np.testing.assert_array_equal(rr.counters.bcd_iters.numpy(),
                                  np.asarray(rj.counters.bcd_iters))
    assert rr.allocation.bandwidth.shape == (4, 64)
    assert rr.allocation.T.shape == (4,)


def test_fleet_f32_matches(fleet):
    rj, rr = solve_both(*fleet, MIXED, max_iters=8, dtype="float32",
                        tol=1e-5)
    assert rr.objective.dtype == torch.float32
    np.testing.assert_allclose(rr.objective.numpy(), np.asarray(rj.objective),
                               rtol=1e-4)
    assert np.all(np.abs(rr.iters.numpy() - np.asarray(rj.iters)) <= 1)


def test_fleet_rows_equal_single_cell_solves(fleet):
    """Batching is exact in the port: each fleet row is its own solve."""
    _, ft = fleet
    res = rt.solve(rt.Problem(system=ft, weights=[rt.Weights(*w)
                                                  for w in MIXED]),
                   rt.SolverSpec(max_iters=8))
    for c, w in enumerate(MIXED):
        one = rt.solve(rt.Problem(system=ft.cell(c), weights=rt.Weights(*w)),
                       rt.SolverSpec(max_iters=8))
        assert one.iters == int(res.iters[c])
        assert one.objective == pytest.approx(float(res.objective[c]),
                                              rel=1e-12)


def test_warm_start_matches(paper_cell):
    sj, st = paper_cell
    w = (0.5, 0.5, 1.0)
    cold_j, cold_t = solve_both(sj, st, w, max_iters=2)
    warm_j = repro.solve(repro.Problem(system=sj, weights=repro.Weights(*w),
                                       init=cold_j.allocation),
                         repro.SolverSpec())
    warm_t = rt.solve(rt.Problem(system=st, weights=rt.Weights(*w),
                                 init=cold_t.allocation), rt.SolverSpec())
    assert warm_t.iters == warm_j.iters
    assert warm_t.objective == pytest.approx(warm_j.objective, rel=1e-6)


def test_max_iters_zero_returns_the_init(paper_cell):
    _, st = paper_cell
    res = rt.solve(rt.Problem(system=st, weights=rt.Weights(0.5, 0.5, 1.0)),
                   rt.SolverSpec(max_iters=0))
    assert res.iters == 0 and not res.converged and math.isnan(res.objective)
    assert res.history == []
    init = rt.core.bcd.initial_allocation(st)
    for x, y in zip(res.allocation.astuple(), init.astuple()):
        assert torch.equal(x, y)


def test_keep_history_false_keeps_the_objective(paper_cell):
    _, st = paper_cell
    problem = rt.Problem(system=st, weights=rt.Weights(0.5, 0.5, 1.0))
    full = rt.solve(problem, rt.SolverSpec(max_iters=5))
    lean = rt.solve(problem, rt.SolverSpec(max_iters=5, keep_history=False))
    assert lean.history == [] and lean.objective == full.objective


# rounds and the mesh are ported: a mesh over one cell raises the
# reference's ValueError; assoc still waits for ROADMAP item 10
@pytest.mark.parametrize("extra", [
    dict(rounds=rt.RoundsConfig(rounds=1), key=0, mesh=object()),
    dict(mesh=object()), dict(assoc=object())])
def test_unported_topologies_raise(paper_cell, extra):
    _, st = paper_cell
    problem = rt.Problem(system=st, weights=rt.Weights(0.5, 0.5, 1.0),
                         **extra)
    if "assoc" in extra:
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md Queue 1 item 10"):
            rt.solve(problem, rt.SolverSpec())
    else:
        with pytest.raises(ValueError, match="mesh requires a stacked"):
            rt.solve(problem, rt.SolverSpec())


def test_solve_runs_where_the_system_lives(paper_cell):
    _, st = paper_cell
    res = rt.solve(rt.Problem(system=st.to(dtype=torch.float32),
                              weights=rt.Weights(0.5, 0.5, 1.0)),
                   rt.SolverSpec(max_iters=3))
    assert res.allocation.bandwidth.device.type == "cpu"
    assert res.allocation.bandwidth.dtype == torch.float32


def test_padded_cell_matches(paper_cell):
    """A cell padded with masked lanes (`repro.region.batch.pad_system`)
    solves like the reference's, and its pad lanes get no bandwidth."""
    from repro.region.batch import pad_system

    sj = pad_system(paper_cell[0], 64)
    leaves = {k: np.asarray(getattr(sj, k)) for k in _SYS_ARRAYS + _SYS_SCALARS}
    leaves["active"] = np.asarray(sj.active)
    st = interop.system_from_numpy(leaves, sj.resolutions, device="cpu")
    rj, rr = solve_both(sj, st, (0.5, 0.5, 1.0))
    assert rr.iters == rj.iters
    assert rr.objective == pytest.approx(rj.objective, rel=1e-6)
    np.testing.assert_allclose(rr.allocation.bandwidth.numpy(),
                               np.asarray(rj.allocation.bandwidth),
                               rtol=1e-6, atol=1e-6)
    assert torch.all(rr.allocation.bandwidth[50:] == 0)
