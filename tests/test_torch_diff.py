"""`repro_torch.diff.solve_and_grad` against `repro.diff.solve_and_grad` on
the CPU, float64: the single and padded problems of tests/test_diff_grad.py
(values and gradients w.r.t. the weights, the SP1-side leaves and the
channel-side leaves), pad-lane gradients exactly 0, and the port held
against the reference's finite-difference-checked gradients (the
reference's bisect spec). The fleet and the dense adjoint are in
tests/test_torch_diff_fleet.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import repro
from repro.diff import solve_and_grad as solve_and_grad_j

import repro_torch as rt
from repro_torch.diff import DEFAULT_WRT, METRICS, solve_and_grad

from _torch_diff import (FD_SPEC, LEAVES, SP1_LEAVES, SPEC, compare_grads,
                         problems, rel)


_SOLVED = {}


def solved_problem(name):
    """(port Problem, repro GradResult, port GradResult) of `name`, solved
    once per module."""
    if name not in _SOLVED:
        pj, pt = problems(name)
        gj = solve_and_grad_j(pj, repro.SolverSpec(**SPEC), wrt=LEAVES)
        gt = solve_and_grad(pt, rt.SolverSpec(**SPEC), wrt=LEAVES)
        _SOLVED[name] = pt, gj, gt
    return _SOLVED[name]


@pytest.mark.parametrize("name", ["single", "padded"])
def test_grads_match_repro(name):
    pt, gj, gt = solved_problem(name)
    compare_grads(gt, gj, LEAVES)
    assert gt.wrt == LEAVES
    for m in METRICS:
        assert gt.value[m].shape == ()
        assert gt.grads[m]["weights"].shape == (3,)
        assert gt.grads[m]["kappa"].shape == pt.system.kappa.shape
        assert gt.grads[m]["cycles"].shape == pt.system.cycles.shape


@pytest.mark.parametrize("name", ["single", "padded"])
def test_value_matches_port_solve(name):
    """The values are the port's own forward solve's: one more Phi step
    from its last iterate (here the 12th; measured: 1.1e-7 relative in the
    objective), whose SP1 is the nested bisection, so the realized f sits
    within the sweep's secant precision (measured: 3e-6) of the sweep
    solve's. The realized allocation is feasible."""
    _, pt = problems(name)
    spec = rt.SolverSpec(max_iters=12)
    g = solve_and_grad(pt, spec, wrt=("kappa",))
    r = rt.solve(pt, spec)
    assert float(g.value["objective"]) == pytest.approx(r.objective,
                                                        rel=1e-6)
    np.testing.assert_allclose(g.allocation.freq.numpy(),
                               r.allocation.freq.numpy(), rtol=1e-5)
    assert rt.core.energy.feasible(pt.system, g.allocation)


def test_pad_lane_grads_exactly_zero():
    pt, _, gt = solved_problem("padded")
    pad = ~pt.system.active
    for m in METRICS:
        for leaf in ("cycles", "samples", "gain"):
            lanes = gt.grads[m][leaf][pad]
            assert torch.equal(lanes, torch.zeros_like(lanes)), (m, leaf)
    assert torch.equal(gt.allocation.bandwidth[pad],
                       torch.zeros(2, dtype=torch.float64))


def test_matches_fd_checked_reference():
    """The reference's gradients at its finite-difference-checked spec
    (tests/test_diff_grad.py: bisect SP1, tol 1e-11, FD parity to 1e-3):
    the port's sweep-spec gradients land on them. Measured: <= 3.9e-9 for
    the weights, <= 6.3e-8 for the SP1-side leaves."""
    pj, pt = problems("single")
    gj = solve_and_grad_j(pj, repro.SolverSpec(**FD_SPEC), wrt=SP1_LEAVES)
    _, _, gt = solved_problem("single")
    for m in ("objective", "energy", "time"):
        for k in ("weights",) + SP1_LEAVES:
            r = rel(gt.grads[m][k].numpy(),
                    np.asarray(gj.grads[m][k]).reshape(gt.grads[m][k].shape))
            assert r <= 1e-6, (m, k, r)
    # the channel side is a descent direction: a better channel never
    # makes the realized objective worse
    g = solve_and_grad(pt, rt.SolverSpec(max_iters=8), wrt=("gain",))
    assert bool((g.grads["objective"]["gain"] <= 1e-9).all())


def test_argument_validation():
    _, pt = problems("single")
    with pytest.raises(ValueError, match="unknown SystemParams leaf"):
        solve_and_grad(pt, wrt=("resolutions",))
    with pytest.raises(ValueError, match="plain BCD"):
        solve_and_grad(rt.Problem(system=pt.system, weights=pt.weights,
                                  deadline=10.0))
    with pytest.raises(ValueError, match=r"\(3,\) or \(C, 3\)"):
        solve_and_grad(rt.Problem(system=pt.system, weights=[1.0, 2.0]))
    assert DEFAULT_WRT == ("gain", "cycles", "bandwidth_total", "kappa")


def test_sp2_stationarity_matches_repro():
    """The SP2 KKT residual dE/dB + mu that the gradient linearizes, with
    its B-derivative (the curvature `_denergy2_dB2`), against the
    reference's on both dE/dB branches."""
    import jax.numpy as jnp
    from repro.core import sp2 as sp2_j

    from repro_torch.core import sp2 as sp2_t

    pj, pt = problems("single")
    rng = np.random.default_rng(3)
    rmin = rng.uniform(2e3, 4e4, 8)
    B = rng.uniform(5e4, 8e5, 8)
    mu = 3e-7
    rj = sp2_j.sp2_stationarity(pj.system, jnp.asarray(rmin), jnp.asarray(B),
                                mu)
    Bt = torch.tensor(B, requires_grad=True)
    rt_ = sp2_t.sp2_stationarity(pt.system, torch.tensor(rmin), Bt, mu)
    np.testing.assert_allclose(rt_.detach().numpy(), np.asarray(rj),
                               rtol=1e-12)
    d, = torch.autograd.grad(rt_.sum(), Bt)
    np.testing.assert_allclose(
        d.numpy(), sp2_t._denergy2_dB2(pt.system, torch.tensor(rmin),
                                       torch.tensor(B)).numpy(), rtol=1e-6)
