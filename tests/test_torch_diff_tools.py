"""`repro_torch.diff`'s host-side tools against `repro.diff` on the CPU:
the learned accuracy surrogate (`fit_surrogate`, `SurrogateAccuracy`,
`problem_with_surrogate`), `pareto_front` / `weight_grid` /
`pareto_sweep`, and `tune_weights`, at the reference tests' sizes
(tests/test_diff_surrogate.py) with a cheaper forward spec: the
reference's bisect spec costs the port ~1e5 small ops per BCD iteration.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

import repro
from repro import diff as diff_j

import repro_torch as rt
from repro_torch.core.accuracy import FIG7_RESOLUTIONS, menu_of
from repro_torch.core.sp1 import round_resolution
from repro_torch.diff import (SurrogateAccuracy, fit_from_training,
                              fit_surrogate, pareto_front, pareto_sweep,
                              problem_with_surrogate, solve_and_grad,
                              tune_weights, weight_grid)

from _torch_diff import to_port

SPEC = dict(max_iters=12)
MENU6 = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0)
ACCS6 = [0.3, 0.45, 0.55, 0.6, 0.63, 0.65]


def sys_pair(n=6, key=0):
    sj = repro.make_system(jax.random.PRNGKey(key), n_devices=n)
    return sj, to_port(sj)


@pytest.mark.parametrize("seed", range(4))
def test_fit_surrogate_matches_repro(seed):
    rng = np.random.default_rng(seed)
    k = 4 + seed
    accs = rng.uniform(0.0, 1.0, k)
    menu = np.sort(rng.uniform(50.0, 1000.0, k)) + np.arange(k)
    model = fit_surrogate(menu, accs, menu=tuple(menu))
    ref = diff_j.fit_surrogate(menu, accs, menu=tuple(menu))
    np.testing.assert_allclose(model.knots, ref.knots, rtol=1e-15)
    np.testing.assert_allclose(model.values, ref.values, rtol=1e-12,
                               atol=1e-15)
    assert model.menu == ref.menu
    grid = torch.tensor(np.geomspace(menu[0] * 0.5, menu[-1] * 2.0, 64))
    v, d = model.value(grid), model.deriv(grid)
    np.testing.assert_allclose(v.numpy(), np.asarray(ref.value(
        jnp.asarray(grid.numpy()))), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(d.numpy(), np.asarray(ref.deriv(
        jnp.asarray(grid.numpy()))), rtol=1e-12, atol=1e-18)
    # monotone nondecreasing and concave in s
    assert bool((v.diff() >= -1e-9).all()) and bool((d >= -1e-12).all())
    assert bool((d.diff() <= 1e-9).all())


def test_fit_surrogate_exact_and_validates():
    menu = np.asarray(FIG7_RESOLUTIONS, float)
    accs = 0.9 - 0.5 / np.sqrt(menu / 100.0)      # concave, increasing
    model = fit_surrogate(menu, accs)
    np.testing.assert_allclose(model.value(torch.tensor(menu)).numpy(),
                               accs, atol=1e-8)
    assert menu_of(model) == tuple(menu)
    with pytest.raises(ValueError):
        SurrogateAccuracy(knots=(1.0,), values=(0.5,), menu=(100.0,))
    with pytest.raises(ValueError):
        fit_surrogate([1.0, 1.0], [0.1, 0.2])
    # fit_from_training is ported (tests/test_torch_fl.py runs it); its
    # menu must match the dataset grid rank for rank, as the reference's
    with pytest.raises(ValueError, match="rank for rank"):
        fit_from_training(0, menu=(160.0, 320.0), device="cpu")


def test_problem_with_surrogate_solves_like_repro():
    sj, st = sys_pair()
    model = fit_surrogate(MENU6, ACCS6, menu=MENU6)
    prob = problem_with_surrogate(
        rt.Problem(system=st, weights=rt.Weights(0.5, 0.5, 0.3)), model)
    assert prob.system.resolutions == MENU6
    spec = dict(max_iters=2)   # the generic SP1 sweep bisects per point
    r = rt.solve(prob, rt.SolverSpec(**spec))
    assert set(r.allocation.resolution.tolist()) <= set(MENU6)
    snapped = round_resolution(prob.system,
                               torch.tensor([90.0, 260.0, 640.0]))
    assert snapped.tolist() == [100.0, 300.0, 600.0]
    pj = diff_j.problem_with_surrogate(
        repro.Problem(system=sj, weights=repro.Weights(0.5, 0.5, 0.3)),
        diff_j.fit_surrogate(MENU6, ACCS6, menu=MENU6))
    rj = repro.solve(pj, repro.SolverSpec(**spec))
    assert r.iters == rj.iters
    assert r.objective == pytest.approx(rj.objective, rel=1e-6)


def test_surrogate_stationarity_gradients_match_repro():
    """The generic-model gradient path (`_s_of_lambda_diff`'s Newton step
    on the detached bisection, inside `sp1_stationarity`) against the
    reference's: residuals and their gradients w.r.t. lam, T, kappa and
    rho, at a dual point where every lane is interior."""
    from repro.core import sp1 as sp1_j
    from repro_torch.core import sp1 as sp1_t

    sj, st = sys_pair()
    model_t = fit_surrogate(MENU6, ACCS6, menu=MENU6)
    model_j = diff_j.fit_surrogate(MENU6, ACCS6, menu=MENU6)
    sj, st = sj.replace(resolutions=MENU6), st.replace(resolutions=MENU6)
    lam = np.linspace(2.0, 9.0, 6)
    tt = np.linspace(0.01, 0.02, 6)
    T, kappa, rho = 0.2, float(st.kappa), 0.3

    def f_j(lam_, T_, kappa_, rho_):
        s = sj.replace(kappa=kappa_)
        w = repro.Weights(0.5, 0.5, rho_)
        r_n, r_sum = sp1_j.sp1_stationarity(s, w, model_j, lam_, T_,
                                            jnp.asarray(tt))
        return jnp.sum(r_n * jnp.arange(1.0, 7.0)) + r_sum, r_n

    (vj, rj), gj = jax.value_and_grad(f_j, argnums=(0, 1, 2, 3),
                                      has_aux=True)(
        jnp.asarray(lam), jnp.asarray(T), jnp.asarray(kappa),
        jnp.asarray(rho))
    xs = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
          for v in (lam, T, kappa, rho)]
    b = st.batched().replace(kappa=xs[2].reshape(1, 1))
    w = rt.Weights(torch.tensor([[0.5]], dtype=torch.float64),
                   torch.tensor([[0.5]], dtype=torch.float64),
                   xs[3].reshape(1, 1))
    r_n, r_sum = sp1_t.sp1_stationarity(b, w, model_t, xs[0][None],
                                        xs[1].reshape(1, 1),
                                        torch.tensor(tt)[None])
    v = (r_n[0] * torch.arange(1.0, 7.0, dtype=torch.float64)).sum() \
        + r_sum[0, 0]
    gt = torch.autograd.grad(v, xs)
    np.testing.assert_allclose(r_n[0].detach().numpy(), np.asarray(rj),
                               rtol=1e-10, atol=1e-14)
    assert float(v) == pytest.approx(float(vj), rel=1e-10)
    for a, bj in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(bj), rtol=1e-9)


def test_pareto_front_and_grid():
    e = np.asarray([3.0, 2.0, 1.0, 2.5, np.nan])
    t = np.asarray([1.0, 2.0, 3.0, 2.5, 0.5])
    np.testing.assert_array_equal(pareto_front(e, t),
                                  [True, True, True, False, False])
    g = weight_grid(n=9, rho=0.25)
    np.testing.assert_array_equal(g, diff_j.weight_grid(n=9, rho=0.25))
    with pytest.raises(ValueError):
        weight_grid(n=3, lo=0.5, hi=0.4)


def test_pareto_sweep_matches_repro():
    sj, st = sys_pair(n=6, key=3)
    res = pareto_sweep(rt.Problem(system=st,
                                  weights=rt.Weights(0.5, 0.5, 0.3)),
                       rt.SolverSpec(**SPEC), n=7)
    ref = diff_j.pareto_sweep(
        repro.Problem(system=sj, weights=repro.Weights(0.5, 0.5, 0.3)),
        repro.SolverSpec(**SPEC), n=7)
    assert res.weights.shape == (7, 3)
    np.testing.assert_array_equal(res.converged, np.asarray(ref.converged))
    np.testing.assert_array_equal(res.front, np.asarray(ref.front))
    for m in ("objective", "energy", "time", "accuracy"):
        np.testing.assert_allclose(res.value[m], np.asarray(ref.value[m]),
                                   rtol=1e-8)
        np.testing.assert_allclose(res.grads[m], np.asarray(ref.grads[m]),
                                   rtol=1e-6,
                                   atol=1e-6 * np.abs(ref.grads[m]).max())
    e, t = res.value["energy"], res.value["time"]
    assert res.front.any()
    for i in np.flatnonzero(res.front):
        dominated = (e <= e[i]) & (t <= t[i]) & ((e < e[i]) | (t < t[i]))
        assert not dominated.any(), i


def test_tune_weights_meets_latency_target():
    """A mis-weighted cell pulled onto its latency budget, step for step as
    repro's tuner walks."""
    sj, st = sys_pair(n=8, key=3)
    prob = rt.Problem(system=st, weights=rt.Weights(0.9, 0.1, 0.3))
    spec = rt.SolverSpec(max_iters=8)
    t0 = float(solve_and_grad(prob, spec, wrt=()).value["time"])
    target = 0.9 * t0
    out = tune_weights(prob, spec, target_time=target, steps=16)
    assert out.met, out
    assert out.target_time == pytest.approx(target)
    assert out.steps <= 16 and len(out.history) == out.steps
    tuned = solve_and_grad(dataclasses.replace(prob, weights=out.weights),
                           spec, wrt=())
    assert float(tuned.value["time"]) <= target * (1 + 1e-6)
    ref = diff_j.tune_weights(
        repro.Problem(system=sj, weights=repro.Weights(0.9, 0.1, 0.3)),
        repro.SolverSpec(max_iters=8), target_time=target, steps=16)
    assert out.steps == ref.steps and out.met == ref.met
    for a, b in zip(out.history, ref.history):
        for k in ("w1", "w2", "energy", "time"):
            assert a[k] == pytest.approx(b[k], rel=1e-6), k
    with pytest.raises(ValueError):
        tune_weights(prob, spec)                             # neither target
    with pytest.raises(ValueError):
        tune_weights(prob, spec, target_time=1.0, slos=())   # both
