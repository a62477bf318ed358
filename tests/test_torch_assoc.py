"""The port's cross-cell association (`repro_torch.assoc`,
`Problem.assoc`) against `repro.assoc`, on the CPU in float64.

Scenarios are built by `repro.assoc.make_multicell`; the port's
`make_multicell` is fed the reference's positions and base system
(`tests/_torch_fl.py::multicell_inputs`). Every `solve_assoc` comparison
uses one (C, N) shape and one `SolverSpec`, so the reference compiles its
fleet solve once. The invariants of `tests/test_assoc.py` (partition,
capacity, strict descent, fixed point, outer_iters=0 = the fleet solve)
are checked on the port's own scenarios.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_stub import given, settings, st

import repro
from repro.assoc import make_multicell as make_multicell_j
from repro.assoc.loop import greedy_assign as greedy_assign_j
from repro.assoc.loop import marginal_costs as marginal_costs_j
from repro.assoc.loop import nearest_assignment as nearest_assignment_j
from repro.core.accuracy import default_accuracy as default_accuracy_j

import repro_torch as rt
from repro_torch import obs
from repro_torch.assoc import (AssocConfig, greedy_assign, make_multicell,
                               marginal_costs, nearest_assignment,
                               solve_assoc)
from repro_torch.assoc.loop import _base_active, _cell_objectives

from _torch_fl import multicell_inputs

C, N = 3, 16
W = (0.5, 0.5, 5.0)
SPEC = dict(max_iters=6, tol=1e-5)
FIELDS = ("bandwidth", "power", "freq", "resolution", "s_relaxed", "T")


def bandwidths(C=C):
    return [5e6 * (c + 1) for c in range(C)]


def scenario_pair(seed, C=C, N=N, **scalars):
    """(repro's multicell system, the port's built from the same draws)."""
    key = jax.random.PRNGKey(seed)
    sj = make_multicell_j(key, n_cells=C, n_devices=N,
                          bandwidth_total=bandwidths(C), **scalars)
    shadow = scalars.pop("shadowing_db", None)
    base, pos = multicell_inputs(key, N, **scalars)
    extra = {} if shadow is None else dict(shadowing_db=shadow)
    st_ = make_multicell(None, C, N, positions=torch.tensor(pos), base=base,
                         bandwidth_total=bandwidths(C), **extra)
    return sj, st_


def port_scenario(seed, C=C, N=N, **kw):
    kw.setdefault("bandwidth_total", bandwidths(C))
    return make_multicell(seed, C, N, device="cpu", dtype=torch.float64,
                          **kw)


def check_invariants(sysb, res, capacity=None):
    C_, N_ = sysb.gain.shape
    assign = np.asarray(res.assignment)
    active = _base_active(sysb)
    assert assign.shape == (N_,)
    assert ((assign >= 0) & (assign < C_))[active].all()
    assert (assign[~active] == -1).all()
    load = np.bincount(assign[active], minlength=C_)
    cap = AssocConfig(capacity=capacity).per_cell_capacity(C_, N_)
    assert (load <= cap).all(), (load, cap)
    objs = np.asarray(res.objectives)
    assert np.isfinite(objs).all()
    assert (np.diff(objs) < 0).all()
    assert res.objective == objs[-1]


def assert_same_fleet(a, b):
    for f in FIELDS:
        x, y = getattr(a.allocation, f), getattr(b.allocation, f)
        assert (x is None and y is None) or torch.equal(x, y), f
    assert torch.equal(a.iters, b.iters)
    assert torch.equal(a.objective, b.objective)


# ---------------------------------------------------------------------------
# scenario, masks, host bookkeeping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scalars", [{}, dict(p_max=0.02, shadowing_db=6.0)])
def test_make_multicell_matches_repro(scalars):
    sj, st_ = scenario_pair(0, **scalars)
    np.testing.assert_allclose(st_.gain.numpy(), np.asarray(sj.gain),
                               rtol=1e-12, atol=0)
    for k in ("cycles", "samples", "bits"):
        np.testing.assert_array_equal(getattr(st_, k).numpy(),
                                      np.asarray(getattr(sj, k)))
    for k in ("bandwidth_total", "p_max", "noise_psd", "f_max",
              "global_rounds", "s_standard"):
        np.testing.assert_array_equal(getattr(st_, k).numpy().ravel(),
                                      np.asarray(getattr(sj, k)))
    assert st_.resolutions == sj.resolutions and st_.active is None


def test_make_multicell_from_a_generator():
    s1 = port_scenario(7, C=4, N=32, p_max=[0.01, 0.02, 0.03, 0.04])
    s2 = port_scenario(7, C=4, N=32, p_max=[0.01, 0.02, 0.03, 0.04])
    assert torch.equal(s1.gain, s2.gain)
    assert s1.gain.shape == (4, 32) and s1.p_max.shape == (4, 1)
    assert s1.p_max.ravel().tolist() == [0.01, 0.02, 0.03, 0.04]
    # device attributes shared across rows, every gain positive and finite
    assert bool((s1.cycles == s1.cycles[:1]).all())
    assert bool((s1.gain > 0).all() and torch.isfinite(s1.gain).all())
    # each device's strongest cell is its nearest base station's: about a
    # quarter of the devices a cell on a 2 x 2 grid
    load = np.bincount(s1.gain.argmax(0).numpy(), minlength=4)
    assert load.min() >= 2
    with pytest.raises(ValueError, match="per-cell override"):
        port_scenario(7, C=4, N=32, p_max=[0.01, 0.02])
    base = rt.make_system(0, 8, device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="would not reach"):
        make_multicell(None, 2, 8, positions=torch.zeros(8, 2), base=base,
                       p_max=0.02)
    with pytest.raises(ValueError, match="give a generator"):
        make_multicell(None, 2, 8, base=base)


def test_with_assignment_mask_semantics():
    sysb = port_scenario(1, N=8)
    assign = np.array([0, 1, 2, 0, 1, 2, -1, 0], np.int32)
    act = sysb.with_assignment(assign).active.numpy()
    assert act.shape == (3, 8)
    for n, c in enumerate(assign):
        col = np.zeros(3, bool)
        if c >= 0:
            col[c] = True
        assert np.array_equal(act[:, n], col)
    base_mask = torch.zeros(3, 8, dtype=torch.bool)
    base_mask[:, :4] = True
    act2 = sysb.replace(active=base_mask).with_assignment(
        torch.as_tensor(assign)).active
    assert not bool(act2[:, 4:].any())
    assert torch.equal(act2[:, :4], torch.as_tensor(act[:, :4]))
    with pytest.raises(ValueError, match="not stacked"):
        sysb.cell(0).with_assignment(assign)


def test_greedy_and_nearest_assignment_match_repro():
    rng = np.random.default_rng(0)
    cost = rng.standard_normal((4, 20))
    cap = np.array([5, 6, 4, 5])
    active = rng.random(20) < 0.9
    order = rng.permutation(20)
    np.testing.assert_array_equal(greedy_assign(cost, cap, active, order),
                                  greedy_assign_j(cost, cap, active, order))
    sj, st_ = scenario_pair(2)
    for cap in (np.full(C, N), np.full(C, 6)):
        np.testing.assert_array_equal(nearest_assignment(st_, cap),
                                      nearest_assignment_j(sj, cap))
    with pytest.raises(ValueError, match="cannot serve"):
        greedy_assign(cost, np.array([1, 1, 1, 1]), np.ones(20, bool),
                      order)


def test_marginal_costs_and_cell_objectives_match_repro():
    sj, st_ = scenario_pair(3)
    cap = np.full(C, N)
    assign = nearest_assignment_j(sj, cap)
    masked_j = sj.with_assignment(jax.numpy.asarray(assign))
    fleet_j = repro.solve(repro.Problem(system=masked_j,
                                        weights=repro.Weights(*W)),
                          repro.SolverSpec(**SPEC))
    from repro.api.problem import weights_leaf as weights_leaf_j
    from repro.assoc.loop import _cell_objectives as cell_objectives_j

    warr = np.asarray(weights_leaf_j(repro.Weights(*W), np.float64,
                                     cells=C))
    alloc = rt.Allocation(**{
        f: torch.tensor(np.asarray(getattr(fleet_j.allocation, f)))
        for f in ("bandwidth", "power", "freq", "resolution")})
    masked = st_.with_assignment(assign)
    got = marginal_costs(masked, warr, rt.default_accuracy(), alloc, assign)
    want = marginal_costs_j(masked_j, warr, default_accuracy_j(),
                            fleet_j.allocation, assign)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    objs = _cell_objectives(masked, torch.tensor(warr),
                            rt.default_accuracy(), alloc)
    np.testing.assert_allclose(
        objs.numpy(), cell_objectives_j(masked_j, warr, default_accuracy_j(),
                                        fleet_j.allocation),
        rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# the outer loop against repro
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,cfg", [
    (1, dict(outer_iters=6)),
    (1, dict(outer_iters=6, capacity=(7, 7, 6))),
    (4, dict(outer_iters=6, warm_start=False)),
])
def test_solve_assoc_matches_repro(seed, cfg):
    sj, st_ = scenario_pair(seed)
    rj = repro.solve(repro.Problem(system=sj, weights=repro.Weights(*W),
                                   assoc=repro.AssocConfig(**cfg)),
                     repro.SolverSpec(**SPEC))
    rp = rt.solve(rt.Problem(system=st_, weights=rt.Weights(*W),
                             assoc=AssocConfig(**cfg)), rt.SolverSpec(**SPEC))
    np.testing.assert_array_equal(rp.assignment, rj.assignment)
    assert rp.moves == rj.moves and rp.outer_iters == rj.outer_iters
    assert rp.converged == rj.converged
    np.testing.assert_allclose(rp.objectives, rj.objectives, rtol=1e-9)
    np.testing.assert_allclose(rp.fleet.allocation.bandwidth.numpy(),
                               np.asarray(rj.fleet.allocation.bandwidth),
                               rtol=1e-9, atol=1e-9 * 5e6)
    np.testing.assert_array_equal(rp.fleet.iters.numpy(),
                                  np.asarray(rj.fleet.iters))
    check_invariants(st_, rp, cfg.get("capacity"))


def test_outer0_is_the_fleet_solve_bit_for_bit():
    st_ = port_scenario(3, N=32)
    spec = rt.SolverSpec(**SPEC)
    res = solve_assoc(rt.Problem(system=st_, weights=rt.Weights(*W),
                                 assoc=AssocConfig(outer_iters=0)), spec)
    assert res.converged and res.outer_iters == 0 and res.moves == []
    np.testing.assert_array_equal(
        res.assignment, nearest_assignment(st_, np.full(C, 32)))
    direct = rt.solve(rt.Problem(system=st_.with_assignment(res.assignment),
                                 weights=rt.Weights(*W)), spec)
    assert_same_fleet(res.fleet, direct)


def test_mesh_equals_no_mesh_bit_for_bit():
    st_ = port_scenario(5, N=32)
    cfg = AssocConfig(outer_iters=2)
    spec = rt.SolverSpec(**SPEC)
    plain = rt.solve(rt.Problem(system=st_, weights=rt.Weights(*W),
                                assoc=cfg), spec)
    meshed = rt.solve(rt.Problem(system=st_, weights=rt.Weights(*W),
                                 assoc=cfg,
                                 mesh=rt.region_mesh(devices=["cpu"] * 2)),
                      spec)
    assert isinstance(meshed.fleet, rt.RegionResult)
    np.testing.assert_array_equal(meshed.assignment, plain.assignment)
    assert meshed.objectives == plain.objectives
    assert meshed.moves == plain.moves
    assert_same_fleet(meshed.fleet.fleet, plain.fleet)


def test_validation_errors_as_repro():
    st_ = port_scenario(0)
    w = rt.Weights(*W)
    with pytest.raises(ValueError, match="stacked"):
        rt.solve(rt.Problem(system=st_.cell(0), weights=w,
                            assoc=AssocConfig()))
    with pytest.raises(ValueError, match="exclusive"):
        rt.solve(rt.Problem(system=st_, weights=w, assoc=AssocConfig(),
                            deadline=100.0))
    with pytest.raises(ValueError, match="exclusive"):
        rt.solve(rt.Problem(system=st_, weights=w, assoc=AssocConfig(),
                            rounds=rt.RoundsConfig(rounds=1), key=0))
    with pytest.raises(ValueError, match="max_iters"):
        rt.solve(rt.Problem(system=st_, weights=w, assoc=AssocConfig()),
                 rt.SolverSpec(max_iters=0))
    with pytest.raises(ValueError, match="outer_iters"):
        AssocConfig(outer_iters=-1)
    with pytest.raises(ValueError, match="capacities must be"):
        AssocConfig(capacity=-1)
    with pytest.raises(ValueError, match="capacity"):
        solve_assoc(rt.Problem(system=st_, weights=w,
                               assoc=AssocConfig(capacity=(3, 3, 3))))
    with pytest.raises(ValueError, match="assign0 is infeasible"):
        solve_assoc(rt.Problem(system=st_, weights=w, assoc=AssocConfig()),
                    rt.SolverSpec(**SPEC), assign0=np.zeros(N, np.int32) - 1)
    with pytest.raises(ValueError, match="3 capacities for 2 cells"):
        AssocConfig(capacity=[1, 2, 3]).per_cell_capacity(2, 8)
    assert hash(AssocConfig(capacity=[4, 5])) == hash(
        AssocConfig(capacity=(4, 5)))


def test_fixed_point_rerun_and_spans():
    """A converged association rerun from its own fixed point moves
    nothing; every outer step is one `assoc_iter` span with the inner
    re-solve's `solve` span nested under it."""
    st_ = port_scenario(2)
    cfg = AssocConfig(outer_iters=10, warm_start=False)
    p = rt.Problem(system=st_, weights=rt.Weights(*W), assoc=cfg)
    spec = rt.SolverSpec(**SPEC)
    rec = obs.MemoryRecorder()
    with obs.recording(rec):
        run1 = rt.solve(p, spec)
    assert run1.converged
    run2 = solve_assoc(p, spec, assign0=run1.assignment)
    np.testing.assert_array_equal(run2.assignment, run1.assignment)
    assert run2.moves == [] and run2.objective == run1.objective
    iters = [e for e in rec.events if e["name"] == "assoc_iter"]
    assert [e["outer_iter"] for e in iters] == list(range(run1.outer_iters))
    inner = [e for e in rec.events if e["name"] == "solve"
             and e["parent"] in {i["span"] for i in iters}]
    # every accepted move re-solved once; the last step may have re-solved
    # a rejected proposal
    assert len(run1.moves) <= len(inner) <= len(run1.moves) + 1
    top = [e for e in rec.events if e["name"] == "solve"
           and e["parent"] == -1]
    assert [e["topology"] for e in top] == ["assoc"]


def test_float32_spec_dtype_routes():
    st_ = port_scenario(6)
    res = rt.solve(rt.Problem(system=st_, weights=rt.Weights(*W),
                              assoc=AssocConfig(outer_iters=3)),
                   rt.SolverSpec(max_iters=6, tol=1e-4, dtype="float32"))
    assert res.fleet.allocation.bandwidth.dtype == torch.float32
    check_invariants(st_, res)


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 2 ** 16), n_cells=st.integers(2, 4),
       cap_slack=st.integers(0, 3))
def test_property_association_invariants(seed, n_cells, cap_slack):
    """Partition, capacity and strict descent on random port scenarios."""
    sysb = port_scenario(seed, C=n_cells, N=16)
    cap = -(-16 // n_cells) + cap_slack
    res = solve_assoc(rt.Problem(system=sysb, weights=rt.Weights(*W),
                                 assoc=AssocConfig(outer_iters=4,
                                                   capacity=cap)),
                      rt.SolverSpec(max_iters=4, tol=1e-4))
    check_invariants(sysb, res, cap)
