"""The port's SP1 engines beside the LinearAccuracy sweep — the nested
bisection (`method="bisect"`), the generic-accuracy sweep (LogAccuracy),
the fixed-deadline enumeration — against the JAX package on the same
systems, in float64 on the CPU, plus torch mirrors of the KKT and
sweep-vs-bisect regimes of tests/test_sp1_kkt.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

import repro
from repro.core import accuracy as jacc
from repro.core import sp1 as jsp1
from repro.core.types import _SYS_ARRAYS, _SYS_SCALARS

import repro_torch as rt
from repro_torch import interop
from repro_torch.core import accuracy as tacc
from repro_torch.core import sp1 as tsp1
from repro_torch.core.energy import rate
from repro_torch.core.types import Weights

MODELS = {"linear": (jacc.default_accuracy, tacc.default_accuracy),
          "log": (jacc.log_fit, tacc.log_fit)}


def to_port(sysj, dtype=None):
    leaves = {k: np.asarray(getattr(sysj, k))
              for k in _SYS_ARRAYS + _SYS_SCALARS}
    return interop.system_from_numpy(leaves, sysj.resolutions, device="cpu",
                                     dtype=dtype)


def setup(seed=0, n=10, w=(0.5, 0.5, 1.0), dtype=torch.float64):
    """tests/test_sp1_kkt.py::_setup: the equal split at p_max."""
    sj = repro.make_system(jax.random.PRNGKey(seed), n_devices=n)
    st = to_port(sj, dtype)
    B = torch.full((n,), float(sj.bandwidth_total) / n, dtype=dtype)
    p = torch.full((n,), float(sj.p_max), dtype=dtype)
    return sj, st, Weights(*w).normalized(), B, p


def tt_of(st, B, p):
    return st.bits / torch.clamp_min(rate(st, B, p), 1e-12)


def continuous_objective(st, w, acc, B, p, method):
    """SP1 objective at the continuous KKT point (T = the s_hat makespan),
    as tests/test_sp1_kkt.py compares the engines."""
    f, _, s_hat, _ = tsp1.solve_sp1(st, w, acc, B, p, method=method)
    alpha, q = tsp1._coeffs(st, w)
    T_root = float((q * s_hat ** 2 / torch.clamp_min(f, 1e-9)
                    + tt_of(st, B, p)).amax())
    return (float((alpha * s_hat ** 2 * f ** 2).sum())
            + float(w.w2 * st.global_rounds * T_root)
            - float(w.rho * acc.value(s_hat).sum()))


@pytest.mark.parametrize("method, model, w", [
    ("bisect", "linear", (0.9, 0.1, 1.0)), ("bisect", "linear", (0.1, 0.9, 1.0)),
    ("bisect", "linear", (0.0, 1.0, 1.0)), ("sweep", "log", (0.5, 0.5, 20.0)),
    ("sweep", "log", (0.1, 0.9, 1.0))])
def test_engine_matches_repro(method, model, w):
    sj, st, wt, B, p = setup(seed=1, n=12, w=w)
    mj, mt = MODELS[model]
    ref = jsp1.solve_sp1(sj, repro.Weights(*w).normalized(), mj(),
                         jnp.asarray(B.numpy()), jnp.asarray(p.numpy()),
                         method=method)
    ours = tsp1.solve_sp1(st, wt, mt(), B, p, method=method)
    assert ours[0].shape == (12,) and ours[3].shape == ()
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-12)


def test_engines_batch_cells():
    """Cells with their own systems and weights in one batch equal their
    single-cell solves, for the bisection and the generic sweep."""
    ws = [(0.5, 0.5, 1.0), (0.9, 0.1, 20.0)]
    cells = [setup(seed=s, n=6, w=w) for s, w in zip((2, 3), ws)]
    batch = rt.stack_systems([c[1] for c in cells])
    stack = lambda k: torch.stack([c[k] for c in cells])
    tt = tt_of(batch, stack(3), stack(4))
    warr = torch.tensor([[c[2].w1, c[2].w2, c[2].rho] for c in cells],
                        dtype=torch.float64)
    for method, acc in (("bisect", tacc.default_accuracy()),
                        ("sweep", tacc.log_fit())):
        impl = tsp1._SP1_IMPLS[method]
        f, s, s_hat, T = impl(batch, warr, acc, tt)
        for c, (_, st, w, B, p) in enumerate(cells):
            one = tsp1.solve_sp1(st, w, acc, B, p, method=method)
            np.testing.assert_allclose(f[c].numpy(), one[0].numpy(),
                                       rtol=1e-14)
            assert torch.equal(s[c], one[1])
            assert float(T[c, 0]) == pytest.approx(float(one[3]), rel=1e-14)


def test_lambda_inversion_matches_repro():
    """`_lambda_of_T` (56-step bisection) and `_makespan_of_lambda` for
    the log model, on the reference's inputs."""
    sj, st, w, B, p = setup(seed=4, n=16, w=(0.5, 0.5, 20.0))
    jw = repro.Weights(0.5, 0.5, 20.0).normalized()
    tt = tt_of(st, B, p)
    lam_hi = 1e4
    for T in (0.1, 0.5, 3.0):
        ref = jsp1._lambda_of_T(sj, jw, jacc.log_fit(), jnp.asarray(T),
                                jnp.asarray(tt.numpy()), lam_hi)
        ours = tsp1._lambda_of_T(st, w, tacc.log_fit(),
                                 torch.tensor(T, dtype=torch.float64), tt,
                                 torch.tensor(lam_hi, dtype=torch.float64))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=0)
    lam = np.geomspace(1e-6, 1e6, 16)
    np.testing.assert_allclose(
        tsp1._makespan_of_lambda(st, w, tacc.log_fit(), torch.tensor(lam),
                                 tt).numpy(),
        np.asarray(jsp1._makespan_of_lambda(sj, jw, jacc.log_fit(),
                                            jnp.asarray(lam),
                                            jnp.asarray(tt.numpy()))),
        rtol=1e-13)


def test_dual_evals_per_iter_matches():
    for method in ("sweep", "bisect"):
        for model in MODELS.values():
            assert tsp1.dual_evals_per_iter(method, model[1]()) \
                == jsp1.dual_evals_per_iter(method, model[0]())
    with pytest.raises(ValueError):
        tsp1.dual_evals_per_iter("newton", tacc.default_accuracy())
    with pytest.raises(ValueError):
        _, st, w, B, p = setup()
        tsp1.solve_sp1(st, w, tacc.default_accuracy(), B, p, method="newton")


# ---------------------------------------------------------------------------
# mirrors of tests/test_sp1_kkt.py
# ---------------------------------------------------------------------------

def check_kkt(st, w, acc, B, p, method, lam_tol=1e-3):
    f, s, s_hat, T = tsp1.solve_sp1(st, w, acc, B, p, method=method)
    tt = tt_of(st, B, p)
    _, q = tsp1._coeffs(st, w)
    assert bool((f >= st.f_min * (1 - 1e-9)).all())
    assert bool((f <= st.f_max * (1 + 1e-9)).all())
    assert bool((s_hat >= st.s_lo * (1 - 1e-9)).all())
    assert bool((s_hat <= st.s_hi * (1 + 1e-9)).all())
    mk_hat = q * s_hat ** 2 / torch.clamp_min(f, 1e-9) + tt
    assert bool((mk_hat <= T * (1 + 1e-6)).all())
    mk_disc = q * s ** 2 / torch.clamp_min(f, 1e-9) + tt
    assert bool((mk_disc <= T * (1 + 1e-6)).all())
    T_root = mk_hat.amax()
    lam_hi, target, T_lo, _ = tsp1._sp1_bounds(st, w, q, tt)
    lam = tsp1._lambda_of_T(st, w, acc, T_root, tt, lam_hi)
    total, target = float(lam.sum()), float(target)
    if float(T_root) <= float(T_lo) * (1 + 1e-9):
        assert total <= target * (1 + lam_tol)
    else:
        assert total == pytest.approx(target, rel=lam_tol)


@pytest.mark.parametrize("method", ["sweep", "bisect"])
@pytest.mark.parametrize("w", [(0.9, 0.1, 1.0), (0.5, 0.5, 10.0),
                               (0.1, 0.9, 1.0)])
def test_kkt_invariants_linear(method, w):
    _, st, wt, B, p = setup(seed=1, n=12, w=w)
    check_kkt(st, wt, tacc.default_accuracy(), B, p, method)


def test_kkt_invariants_log_model():
    """The log model through the generic sweep (the bisection engine on a
    non-linear model runs ~150k evaluations; its parity with repro is
    covered by the engines it shares, `_lambda_of_T` above and the
    LinearAccuracy bisection)."""
    _, st, w, B, p = setup(seed=2, n=9, w=(0.5, 0.5, 20.0))
    check_kkt(st, w, tacc.log_fit(), B, p, "sweep")


def test_makespan_monotone_decreasing_in_lambda():
    _, st, w, B, p = setup(seed=3, n=8)
    tt = tt_of(st, B, p)
    lams = torch.logspace(-8, 8, 120, dtype=torch.float64)[:, None]
    mk = tsp1._makespan_of_lambda(st, w, tacc.default_accuracy(),
                                  lams.expand(120, 8), tt)
    diffs = (mk[1:] - mk[:-1]).numpy()
    assert (diffs <= 1e-9 * np.abs(mk[:-1].numpy())).all()


def test_closed_form_lambda_matches_bisection():
    _, st, w, B, p = setup(seed=4, n=16)
    acc = tacc.default_accuracy()
    tt = tt_of(st, B, p)
    _, q = tsp1._coeffs(st, w)
    lam_hi = tsp1._sp1_bounds(st, w, q, tt)[0]
    k3 = 2.0 * w.w1 * st.global_rounds * st.kappa
    for T in [float(tt.amax()) * 1.7, 0.1, 0.5, 3.0]:
        T = torch.tensor(T, dtype=torch.float64)
        lam_bis = tsp1._lambda_of_T(st, w, acc, T, tt, lam_hi)
        lam_cf = tsp1.lambda_of_T_linear(T, q, tt, k3, w.rho * acc.slope,
                                         st.f_min, st.f_max, st.s_lo,
                                         st.s_hi, lam_hi)
        np.testing.assert_allclose(lam_cf.numpy(), lam_bis.numpy(),
                                   rtol=1e-6, atol=1e-9 * float(lam_hi))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["sweep", "bisect"])
def test_pure_latency_weighting_is_finite(dtype, method):
    _, st, w, B, p = setup(seed=13, n=8, w=(0.0, 1.0, 1.0), dtype=dtype)
    f, s, s_hat, T = tsp1.solve_sp1(st, w, tacc.default_accuracy(), B, p,
                                    method=method)
    assert bool(torch.isfinite(f).all() and torch.isfinite(s_hat).all())
    assert bool(torch.isfinite(T))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("w", [(0.9, 0.1, 1.0), (0.1, 0.9, 1.0),
                               (0.5, 0.5, 50.0)])
def test_sweep_parity_regimes(dtype, w):
    """Sweep vs bisection on the SP1 objective, <= 1e-5 relative (the
    acceptance bound), LinearAccuracy."""
    _, st, wt, B, p = setup(seed=7, n=24, w=w, dtype=dtype)
    acc = tacc.default_accuracy()
    out = {m: continuous_objective(st, wt, acc, B, p, m)
           for m in ("sweep", "bisect")}
    rel = abs(out["sweep"] - out["bisect"]) / max(abs(out["bisect"]), 1e-30)
    assert rel <= 1e-5


# ---------------------------------------------------------------------------
# the fixed-deadline enumeration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["linear", "log"])
@pytest.mark.parametrize("T_round", [0.3, 0.8, 3.0])
def test_fixed_T_matches_repro(model, T_round):
    sj, st, w, B, p = setup(seed=5, n=12, w=(0.9, 0.1, 5.0))
    mj, mt = MODELS[model]
    fj, s_j = jsp1.solve_sp1_fixed_T(
        sj, repro.Weights(0.9, 0.1, 5.0).normalized(), mj(),
        jnp.asarray(B.numpy()), jnp.asarray(p.numpy()), T_round)
    f, s = tsp1.solve_sp1_fixed_T(st, w, mt(), B, p, T_round)
    np.testing.assert_allclose(f.numpy(), np.asarray(fj), rtol=1e-14)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))


def test_fixed_T_takes_a_deadline_per_cell():
    cells = [setup(seed=s, n=8, w=(0.9, 0.1, 5.0)) for s in (6, 7, 8)]
    batch = rt.stack_systems([c[1] for c in cells])
    stack = lambda k: torch.stack([c[k] for c in cells])
    deadlines = [0.4, 0.9, 2.0]
    f, s = tsp1.solve_sp1_fixed_T(batch, cells[0][2], tacc.default_accuracy(),
                                  stack(3), stack(4),
                                  torch.tensor(deadlines, dtype=torch.float64))
    for c, (_, st, w, B, p) in enumerate(cells):
        f1, s1 = tsp1.solve_sp1_fixed_T(st, w, tacc.default_accuracy(), B, p,
                                        deadlines[c])
        assert torch.equal(f[c], f1) and torch.equal(s[c], s1)


# ---------------------------------------------------------------------------
# Algorithm 2 with sp1_method="bisect" and the log model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec, acc", [
    (dict(max_iters=4, sp1_method="bisect"), None),
    (dict(max_iters=4), "log")])
def test_solve_matches_repro(spec, acc):
    sj = repro.make_system(jax.random.PRNGKey(4), n_devices=8)
    w = (0.5, 0.5, 20.0)
    rj = repro.solve(repro.Problem(
        system=sj, weights=repro.Weights(*w),
        acc=None if acc is None else jacc.log_fit()),
        repro.SolverSpec(**spec))
    rr = rt.solve(rt.Problem(
        system=to_port(sj), weights=Weights(*w),
        acc=None if acc is None else tacc.log_fit()), rt.SolverSpec(**spec))
    assert rr.iters == rj.iters and rr.converged == rj.converged
    assert rr.objective == pytest.approx(rj.objective, rel=1e-6)
    cj, ct = rj.counters.as_dict(), rr.counters.as_dict()
    assert ct["sp1_evals"] == cj["sp1_evals"]
    np.testing.assert_array_equal(rr.allocation.resolution.numpy(),
                                  np.asarray(rj.allocation.resolution))
    np.testing.assert_allclose(rr.allocation.freq.numpy(),
                               np.asarray(rj.allocation.freq), rtol=1e-6)
