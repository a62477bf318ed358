"""The port's SP2 engines beside `direct`'s default form — the paper-literal
Theorem-2 path (`solve_sp2_v2_thm2`, through the `waterfill_gprime` sweep),
SP2_v2 and Algorithm 1 (`solve_sp2_v2`, `solve_sp2`, `sp2_method="jong"`),
and `direct`'s non-carried / non-Newton oracle forms — against the JAX
package on the same systems, in float64 on the CPU, plus torch mirrors of
tests/test_sp2_paper_path.py, tests/test_sp2_bracket.py and the SP2 tests
of tests/test_core_allocator.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

import repro
from repro.core import sp2 as jsp2
from repro.core.energy import t_cmp as jt_cmp
from repro.core.types import _SYS_ARRAYS, _SYS_SCALARS

import repro_torch as rt
from repro_torch import interop
from repro_torch.core import sp2 as tsp2
from repro_torch.core.bcd import initial_allocation
from repro_torch.core.loops import while_cells
from repro_torch.core.types import Weights

W = Weights(0.5, 0.5, 1.0).normalized()
JW = repro.Weights(0.5, 0.5, 1.0).normalized()
# the dual search's eval count rides data-dependent exits; XLA's fused
# arithmetic moves them (ROADMAP.md Queue 3)
EV_SLACK = 6


def to_port(sysj, dtype=None):
    leaves = {k: np.asarray(getattr(sysj, k))
              for k in _SYS_ARRAYS + _SYS_SCALARS}
    if sysj.active is not None:
        leaves["active"] = np.asarray(sysj.active)
    return interop.system_from_numpy(leaves, sysj.resolutions, device="cpu",
                                     dtype=dtype)


def t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def tight_instance(seed=0, n=8):
    """A deadline that leaves just enough rate headroom for every device's
    rate constraint to bind (tests/test_sp2_paper_path.py), with the duals
    (nu, beta) of the equal split at p_max."""
    sj = repro.make_system(jax.random.PRNGKey(seed), n_devices=n)
    B0 = jnp.full((n,), sj.bandwidth_total / n)
    p0 = jnp.full((n,), sj.p_max)
    rate0 = jsp2.G(sj, p0, B0)
    rmin = jsp2._clamp_rmin(sj, 0.9 * rate0)
    nu = JW.w1 * sj.global_rounds / rate0
    beta = sj.p_max * sj.bits / rate0
    return sj, to_port(sj), (nu, beta, rmin)


def rand_instance(seed, n=4):
    """tests/test_core_allocator.py::_rand_instance: a slack deadline."""
    sj = repro.make_system(jax.random.PRNGKey(seed), n_devices=n)
    f = jax.random.uniform(jax.random.PRNGKey(seed + 100), (n,), minval=3e8,
                           maxval=sj.f_max)
    res = jnp.asarray(sj.resolutions)
    s = res[jax.random.randint(jax.random.PRNGKey(seed + 7), (n,), 0, 4)]
    T = float(jnp.max(jt_cmp(sj, f, s))) * 1.5 + 0.02
    rmin = jsp2._clamp_rmin(sj, jsp2.r_min(sj, f, s, jnp.asarray(T)))
    return sj, to_port(sj), rmin


def energy(st, p, B):
    return float((p * st.bits / torch.clamp_min(tsp2.G(st, p, B), 1e-12))
                 .sum())


# ---------------------------------------------------------------------------
# Theorem 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_thm2_matches_repro_kernel_body(seed, monkeypatch):
    """REPRO_FORCE_INTERPRET=1 makes repro's "auto" sweep run the Pallas
    body, the math the port's sweep computes: the same multiplier comes
    out, so B and p agree to 1e-12 relative (only sum orders differ)."""
    sj, st, (nu, beta, rmin) = tight_instance(seed)
    monkeypatch.setenv("REPRO_FORCE_INTERPRET", "1")
    pj, Bj = jsp2.solve_sp2_v2_thm2(sj, JW, nu, beta, rmin)
    pt, Bt = tsp2.solve_sp2_v2_thm2(st, W, t(nu), t(beta), t(rmin))
    assert pt.shape == (8,)
    np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), rtol=1e-12)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 3])
def test_thm2_matches_repro_default_route(seed):
    """repro's CPU route sweeps with the z-form oracle instead of the kernel
    body: the rtol 1e-4 of tests/test_fleet.py's kernelized-vs-scalar
    check."""
    sj, st, (nu, beta, rmin) = tight_instance(seed)
    pj, Bj = jsp2.solve_sp2_v2_thm2(sj, JW, nu, beta, rmin)
    pt, Bt = tsp2.solve_sp2_v2_thm2(st, W, t(nu), t(beta), t(rmin))
    np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), rtol=1e-4)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_thm2_matches_exact_inner_when_tight(seed):
    """Mirror of test_sp2_paper_path.py: thm2 is feasible for the rate floor
    and within 2% of the exact SP2_v2 optimum."""
    _, st, (nu, beta, rmin) = tight_instance(seed)
    nu, beta, rmin = t(nu), t(beta), t(rmin)
    p_t, B_t = tsp2.solve_sp2_v2_thm2(st, W, nu, beta, rmin)
    p_e, B_e = tsp2.solve_sp2_v2(st, W, nu, beta, rmin)

    def v2obj(p, B):
        return float((nu * (p * st.bits - beta * tsp2.G(st, p, B))).sum())

    assert bool((tsp2.G(st, p_t, B_t) >= rmin * (1 - 1e-3)).all())
    exact, lit = v2obj(p_e, B_e), v2obj(p_t, B_t)
    assert lit <= exact + abs(exact) * 0.02 + 1e-12


@pytest.mark.parametrize("seed", [0, 3])
def test_direct_beats_or_ties_thm2_energy(seed):
    _, st, (nu, beta, rmin) = tight_instance(seed)
    p_t, B_t = tsp2.solve_sp2_v2_thm2(st, W, t(nu), t(beta), t(rmin))
    p_d, B_d = tsp2.solve_sp2_direct(st, t(rmin))
    assert energy(st, p_d, B_d) <= energy(st, p_t, B_t) * (1 + 1e-6)


def test_thm2_bandwidth_formula_consistency():
    """At the dual optimum the tight-branch bandwidths sum to ~B."""
    _, st, (nu, beta, rmin) = tight_instance(5)
    _, B_t = tsp2.solve_sp2_v2_thm2(st, W, t(nu), t(beta), t(rmin))
    assert float(B_t.sum()) == pytest.approx(float(st.bandwidth_total),
                                             rel=0.02)


def test_thm2_dual_bracket_covers_tight_deadlines():
    """Mirror of test_fleet.py's tight-deadline check: the root sits near
    1e33, far above any fixed cap; the bracket is sized from the dtype, and
    the port's root equals repro's and brackets the sign change of g'."""
    n = 50
    sj = repro.make_system(jax.random.PRNGKey(0), n_devices=n)
    rmin = jnp.full((n,), 100.0 * sj.bandwidth_total / (n * np.log(2.0)))
    rate0 = jsp2.G(sj, jnp.full((n,), sj.p_max),
                   jnp.full((n,), sj.bandwidth_total / n))
    nu = JW.w1 * sj.global_rounds / rate0
    j = nu * sj.bits * sj.noise_psd / sj.gain
    mu_j = float(jsp2._thm2_dual_mu(sj, j, rmin))
    st = to_port(sj).batched()
    mu = tsp2._thm2_dual_mu(st, t(j)[None], t(rmin)[None])
    assert mu.shape == (1, 1)
    mu = float(mu)
    assert mu > 1e30
    assert mu == pytest.approx(mu_j, rel=1e-10)
    g = tsp2.kops.waterfill_gprime(
        torch.tensor([[mu * (1 - 1e-6), mu * (1 + 1e-6)]]), t(j)[None],
        t(rmin)[None], st.bandwidth_total[:, 0])
    assert float(g[0, 0]) > 0 > float(g[0, 1])


def test_thm2_batches_cells_without_host_reads():
    """Three cells with their own floors and duals in one batch equal three
    single-cell solves, and the sweep never reads back to the host."""
    ins = [tight_instance(seed) for seed in (6, 7, 8)]
    batch = rt.stack_systems([x[1] for x in ins])
    stack = lambda k: torch.stack([t(x[2][k]) for x in ins])
    while_cells.host_reads = 0
    p, B = tsp2.solve_sp2_v2_thm2(batch, W, stack(0), stack(1), stack(2))
    assert while_cells.host_reads == 0
    assert p.shape == B.shape == (3, 8)
    for c, (_, st, (nu, beta, rmin)) in enumerate(ins):
        p1, B1 = tsp2.solve_sp2_v2_thm2(st, W, t(nu), t(beta), t(rmin))
        np.testing.assert_allclose(B[c].numpy(), B1.numpy(), rtol=1e-14)
        np.testing.assert_allclose(p[c].numpy(), p1.numpy(), rtol=1e-14)


def test_thm2_padded_lanes_get_no_bandwidth():
    """A padded cell (`repro.region.batch.pad_system`): masked lanes are
    parked out of the bracket sizing and get B = 0, p = p_min, and the
    active lanes solve as the unpadded cell does."""
    from repro.region.batch import pad_system

    sj, st, (nu, beta, rmin) = tight_instance(2)
    sp = to_port(pad_system(sj, 12))
    pad = lambda x: torch.cat([t(x), torch.zeros(4, dtype=torch.float64)])
    p, B = tsp2.solve_sp2_v2_thm2(sp, W, pad(nu), pad(beta), pad(rmin))
    p1, B1 = tsp2.solve_sp2_v2_thm2(st, W, t(nu), t(beta), t(rmin))
    assert torch.all(B[8:] == 0) and torch.all(p[8:] == sp.p_min)
    np.testing.assert_allclose(B[:8].numpy(), B1.numpy(), rtol=1e-12)
    np.testing.assert_allclose(p[:8].numpy(), p1.numpy(), rtol=1e-12)


# ---------------------------------------------------------------------------
# SP2_v2 and Algorithm 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_sp2_v2_matches_repro(seed):
    sj, st, (nu, beta, rmin) = tight_instance(seed)
    pj, Bj = jsp2.solve_sp2_v2(sj, JW, nu, beta, rmin)
    pt, Bt = tsp2.solve_sp2_v2(st, W, t(nu), t(beta), t(rmin))
    np.testing.assert_allclose(Bt.numpy(), np.asarray(Bj), rtol=1e-6)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6)


def test_sp2_v2_inner_matches_grid():
    """Mirror of test_core_allocator.py: SP2_v2 on two devices is no worse
    than a (bandwidth share x power x power) grid search."""
    _, st, rmin = rand_instance(1, n=2)
    init = initial_allocation(st)
    rate0 = tsp2.G(st, init.power, init.bandwidth)
    nu = W.w1 * st.global_rounds / rate0
    beta = init.power * st.bits / rate0
    p, B = tsp2.solve_sp2_v2(st, W, nu, beta, t(rmin))
    gain, bits = st.gain.numpy(), st.bits.numpy()
    N0, rm = float(st.noise_psd), np.asarray(rmin)
    nuN, betaN = nu.numpy(), beta.numpy()

    def Gnp(pv, Bv):
        return Bv * np.log2(1 + gain * pv / (N0 * Bv))

    def v2obj(pv, Bv):
        return np.sum(nuN * (pv * bits - betaN * Gnp(pv, Bv)), -1)

    ours = float(v2obj(p.numpy(), B.numpy()))
    pg = np.linspace(float(st.p_min), float(st.p_max), 50)
    P = np.stack(np.meshgrid(pg, pg, indexing="ij"), -1).reshape(-1, 2)
    best = np.inf
    for sh in np.linspace(0.002, 0.998, 300):
        Brow = np.array([sh, 1 - sh]) * float(st.bandwidth_total)
        feas = np.all(Gnp(P, Brow[None, :]) >= rm[None, :], -1)
        if feas.any():
            best = min(best, float(v2obj(P[feas], Brow[None, :]).min()))
    assert ours <= best + abs(best) * 1e-3 + 1e-12


def test_jong_matches_repro():
    """Algorithm 1 on a tight instance: the same number of outer steps and
    the same allocation; the residual rides the SP2_v2 argmin, which is
    flat along the budget, so it is held to 1e-4."""
    sj, st, (_, _, rmin) = tight_instance(3)
    n = 8
    B0 = jnp.full((n,), sj.bandwidth_total / n)
    p0 = jnp.full((n,), sj.p_max)
    rj = jsp2.solve_sp2(sj, JW, rmin, p0, B0, max_iters=5)
    rr = tsp2.solve_sp2(st, W, t(rmin), t(p0), t(B0), max_iters=5)
    assert isinstance(rr.iters, int) and rr.iters == rj.iters
    np.testing.assert_allclose(rr.bandwidth.numpy(), np.asarray(rj.bandwidth),
                               rtol=1e-6)
    np.testing.assert_allclose(rr.power.numpy(), np.asarray(rj.power),
                               rtol=1e-6)
    np.testing.assert_allclose(rr.beta.numpy(), np.asarray(rj.beta),
                               rtol=1e-6)
    assert rr.residual == pytest.approx(rj.residual, rel=1e-4)


@pytest.mark.parametrize("seed", [0, 5])
def test_sp2_jong_close_to_direct(seed):
    """Mirror of test_core_allocator.py (there 60 outer steps in float64; 8
    here, in float32): damped Algorithm 1 approaches the exact optimum,
    both feasible."""
    sj, _, rmin = rand_instance(seed, n=6)
    st = to_port(sj, torch.float32)
    rmin = t(rmin, torch.float32)
    init = initial_allocation(st)
    r1 = tsp2.solve_sp2(st, W, rmin, init.power, init.bandwidth, max_iters=8)
    pd, Bd = tsp2.solve_sp2_direct(st, rmin)
    assert energy(st, r1.power, r1.bandwidth) <= energy(st, pd, Bd) * 2.0
    for p, B in [(r1.power, r1.bandwidth), (pd, Bd)]:
        assert bool((tsp2.G(st, p, B) >= rmin * (1 - 1e-6)).all())


# ---------------------------------------------------------------------------
# direct: the oracle forms (tests/test_sp2_bracket.py)
# ---------------------------------------------------------------------------

def bracket_case(dtype, seed, n, slack):
    sj = repro.make_system(jax.random.PRNGKey(seed), n_devices=n,
                           bandwidth_total=20e6 * n / 50)
    st = to_port(sj, dtype)
    f = torch.full((n,), 1e9, dtype=dtype)
    s = torch.full((n,), 320.0, dtype=dtype)
    from repro_torch.core.energy import t_cmp

    T = float(t_cmp(st, f, s).amax()) * slack
    return sj, st, tsp2.r_min(st, f, s, torch.tensor(T, dtype=dtype))


@pytest.mark.parametrize("carry, newton", [(True, True), (True, False),
                                           (False, True)])
@pytest.mark.parametrize("slack", [1.05, 2.0])
def test_direct_forms_match_repro(carry, newton, slack):
    sj, st, rmin = bracket_case(torch.float64, 1, 24, slack)
    pj, Bj, evj = jsp2._sp2_direct_impl(sj, jnp.asarray(rmin.numpy()),
                                        carry, newton)
    pt, Bt, evt = tsp2._sp2_direct_impl(st.batched(), rmin[None], carry,
                                        newton)
    np.testing.assert_allclose(Bt[0].numpy(), np.asarray(Bj), rtol=1e-9)
    np.testing.assert_allclose(pt[0].numpy(), np.asarray(pj), rtol=1e-9)
    assert abs(int(evt[0]) - int(evj)) <= (EV_SLACK if carry and newton
                                           else 0)
    p1, B1 = tsp2.solve_sp2_direct(st, rmin, carry, newton)
    assert torch.equal(B1, Bt[0]) and torch.equal(p1, pt[0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [8, 50])
@pytest.mark.parametrize("slack", [1.05, 1.2, 2.0])
def test_carried_bracket_objective_parity(dtype, n, slack):
    _, st, rmin = bracket_case(dtype, 0, n, slack)
    p_c, B_c = tsp2.solve_sp2_direct(st, rmin)
    p_r, B_r = tsp2.solve_sp2_direct(st, rmin, carry_bracket=False)
    e_c, e_r = energy(st, p_c, B_c), energy(st, p_r, B_r)
    assert abs(e_c - e_r) / max(abs(e_r), 1e-30) <= 1e-6
    for B, p in ((B_c, p_c), (B_r, p_r)):
        assert float(B.sum()) <= float(st.bandwidth_total) * (1 + 1e-6)
        assert bool((tsp2.G(st, p, B) >= rmin * (1 - 1e-5)).all())


@pytest.mark.parametrize("dtype, jdtype", [(torch.float64, jnp.float64),
                                           (torch.float32, jnp.float32)])
def test_carried_bracket_eval_count_drop(dtype, jdtype):
    _, st, rmin = bracket_case(dtype, 1, 50, 1.2)
    ref = tsp2.direct_eval_counts(dtype)
    assert ref == jsp2.direct_eval_counts(jdtype)
    _, _, ev = tsp2._sp2_direct_impl(st.batched(), rmin[None], True)
    assert int(ev[0]) * 3 <= ref
    _, _, ev_ref = tsp2._sp2_direct_impl(st.batched(), rmin[None], False)
    assert int(ev_ref[0]) == ref


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("slack", [1.05, 2.0])
def test_newton_polish_parity_and_eval_drop(dtype, slack):
    _, st, rmin = bracket_case(dtype, 2, 50, slack)
    b = st.batched()
    p_n, B_n, ev_n = tsp2._sp2_direct_impl(b, rmin[None], True, True)
    p_b, B_b, ev_b = tsp2._sp2_direct_impl(b, rmin[None], True, False)
    e_n, e_b = energy(b, p_n, B_n), energy(b, p_b, B_b)
    assert abs(e_n - e_b) / max(abs(e_b), 1e-30) <= 1e-6
    assert int(ev_n[0]) <= int(ev_b[0])


# ---------------------------------------------------------------------------
# Algorithm 2 with sp2_method="jong"
# ---------------------------------------------------------------------------

def test_solve_with_jong_matches_repro():
    sj = repro.make_system(jax.random.PRNGKey(4), n_devices=8)
    spec = dict(max_iters=2, sp2_method="jong", sp2_iters=3)
    rj = repro.solve(repro.Problem(system=sj, weights=repro.Weights(
        0.5, 0.5, 1.0)), repro.SolverSpec(**spec))
    rr = rt.solve(rt.Problem(system=to_port(sj), weights=Weights(
        0.5, 0.5, 1.0)), rt.SolverSpec(**spec))
    assert rr.iters == rj.iters and rr.converged == rj.converged
    assert rr.objective == pytest.approx(rj.objective, rel=1e-6)
    for hj, ht in zip(rj.history, rr.history):
        assert ht["sp2_iters"] == hj["sp2_iters"]
        assert ht["energy"] == pytest.approx(hj["energy"], rel=1e-6)
        assert ht["sp2_residual"] == pytest.approx(hj["sp2_residual"],
                                                   rel=1e-4)
    assert rr.counters.as_dict()["sp2_evals"] \
        == rj.counters.as_dict()["sp2_evals"]


def test_jong_fleet_rows_equal_single_cell_solves():
    fj = repro.make_fleet(jax.random.PRNGKey(9), n_cells=2, n_devices=6)
    ft = to_port(fj)
    spec = rt.SolverSpec(max_iters=2, sp2_method="jong", sp2_iters=2,
                         dtype="float32", tol=1e-5)
    ws = [Weights(0.5, 0.5, 1.0), Weights(0.9, 0.1, 2.0)]
    res = rt.solve(rt.Problem(system=ft, weights=ws), spec)
    for c, w in enumerate(ws):
        one = rt.solve(rt.Problem(system=ft.cell(c), weights=w), spec)
        assert one.iters == int(res.iters[c])
        assert one.objective == float(res.objective[c])
