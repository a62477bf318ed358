"""The port's model layer and solvers (`repro_torch.core`, `.api.spec`,
`.api.problem`) against the JAX package on the same inputs, in float64.

Systems are drawn by `repro` from a seed and brought over through
`repro_torch.interop`; allocations and rate floors come from numpy.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from repro.api import spec as jspec
from repro.api.problem import weights_leaf as jweights_leaf
from repro.core import Weights as JWeights
from repro.core import accuracy as jacc
from repro.core import bcd as jbcd
from repro.core import energy as jen
from repro.core import make_system as jmake_system
from repro.core import sp1 as jsp1
from repro.core import sp2 as jsp2
from repro.core.types import _SYS_ARRAYS, _SYS_SCALARS
from repro.core.types import Allocation as JAllocation

from repro_torch import interop
from repro_torch.api import spec as tspec
from repro_torch.api.problem import weights_leaf as tweights_leaf
from repro_torch.core import accuracy as tacc
from repro_torch.core import bcd as tbcd
from repro_torch.core import energy as ten
from repro_torch.core import sp1 as tsp1
from repro_torch.core import sp2 as tsp2
from repro_torch.core.types import Allocation as TAllocation
from repro_torch.core.types import Weights as TWeights


def to_port(sysj):
    leaves = {k: np.asarray(getattr(sysj, k)) for k in _SYS_ARRAYS + _SYS_SCALARS}
    return interop.system_from_numpy(leaves, sysj.resolutions, device="cpu")


@functools.lru_cache(maxsize=None)
def cell(seed=0, n=50, bw_per_device=None):
    kw = {} if bw_per_device is None else dict(bandwidth_total=bw_per_device * n)
    sj = jmake_system(jax.random.PRNGKey(seed), n_devices=n, **kw)
    return sj, to_port(sj)


def allocation(n, seed=0):
    """numpy (B, p, f, s): a random feasible allocation of a paper cell."""
    rng = np.random.default_rng(seed)
    share = rng.uniform(0.5, 1.5, n)
    B = 20e6 * share / share.sum()
    p = rng.uniform(1e-3, 10 ** 1.2 * 1e-3, n)
    f = rng.uniform(1e8, 2e9, n)
    s = rng.choice([160.0, 320.0, 480.0, 640.0], n)
    return B, p, f, s


def allocs(n, seed=0):
    B, p, f, s = allocation(n, seed)
    return (JAllocation(*(jnp.asarray(x) for x in (B, p, f, s))),
            TAllocation(*(torch.tensor(x) for x in (B, p, f, s))))


def close(ours, ref, rtol):
    np.testing.assert_allclose(np.asarray(ours).reshape(np.shape(ref)),
                               np.asarray(ref), rtol=rtol, atol=0)


# ---------------------------------------------------------------------------
# model layer: types, energy, accuracy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["rate", "t_trans", "e_trans"])
def test_link_model_matches(fn):
    sj, st = cell()
    B, p, _, _ = allocation(50)
    ref = getattr(jen, fn)(sj, jnp.asarray(B), jnp.asarray(p))
    ours = getattr(ten, fn)(st, torch.tensor(B), torch.tensor(p))
    close(ours, ref, 1e-12)


@pytest.mark.parametrize("fn", ["t_cmp", "e_cmp"])
def test_compute_model_matches(fn):
    sj, st = cell()
    _, _, f, s = allocation(50)
    ref = getattr(jen, fn)(sj, jnp.asarray(f), jnp.asarray(s))
    ours = getattr(ten, fn)(st, torch.tensor(f), torch.tensor(s))
    close(ours, ref, 1e-12)


@pytest.mark.parametrize("fn", ["total_energy", "round_time", "total_time"])
def test_system_totals_match(fn):
    sj, st = cell()
    aj, at = allocs(50)
    close(getattr(ten, fn)(st, at), getattr(jen, fn)(sj, aj), 1e-12)


@pytest.mark.parametrize("w", [(0.5, 0.5, 1.0), (0.9, 0.1, 3.0),
                               (0.0, 1.0, 1.0)])
def test_objective_and_accuracy_match(w):
    sj, st = cell()
    aj, at = allocs(50, seed=1)
    acc_j, acc_t = jacc.default_accuracy(), tacc.default_accuracy()
    close(ten.total_accuracy(acc_t, at), jen.total_accuracy(acc_j, aj), 1e-12)
    close(ten.objective(st, TWeights(*w), acc_t, at),
          jen.objective(sj, JWeights(*w), acc_j, aj), 1e-12)
    assert ten.summarize(st, TWeights(*w), acc_t, at) == pytest.approx(
        jen.summarize(sj, JWeights(*w), acc_j, aj), rel=1e-12)


def test_feasibility_check_matches():
    sj, st = cell()
    aj, at = allocs(50, seed=2)
    assert ten.feasible(st, at) == jen.feasible(sj, aj)
    over = TAllocation(at.bandwidth * 2, at.power, at.freq, at.resolution)
    assert not ten.feasible(st, over)


def test_accuracy_models_match():
    s = np.linspace(160.0, 640.0, 7)
    models = [(jacc.default_accuracy(), tacc.default_accuracy()),
              (jacc.log_fit(), tacc.log_fit()),
              (jacc.PowerAccuracy(0.5, 2.0, 0.7),
               tacc.PowerAccuracy(0.5, 2.0, 0.7))]
    for mj, mt in models:
        assert dataclass_fields(mj) == pytest.approx(dataclass_fields(mt))
        close(mt.value(torch.tensor(s)), mj.value(jnp.asarray(s)), 1e-14)
        close(mt.deriv(torch.tensor(s)), mj.deriv(jnp.asarray(s)), 1e-14)
    assert tacc.menu_of(tacc.default_accuracy()) == jacc.menu_of(
        jacc.default_accuracy())


def dataclass_fields(x):
    return [float(v) for v in vars(x).values()]


def test_system_with_menu_rekeys_the_resolutions():
    _, st = cell()

    class WithMenu:
        menu = (100.0, 200.0, 300.0)

    assert tacc.system_with_menu(st, WithMenu()).resolutions == WithMenu.menu
    assert tacc.system_with_menu(st, tacc.default_accuracy()) is st


def test_interop_keeps_every_leaf():
    sj, st = cell()
    for k in _SYS_ARRAYS + _SYS_SCALARS:
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(getattr(sj, k)))
    assert st.resolutions == sj.resolutions and st.dtype == torch.float64
    alloc = interop.allocation_from_numpy(
        dict(zip(("bandwidth", "power", "freq", "resolution"),
                 allocation(50))), device="cpu")
    assert alloc.s_relaxed is None and alloc.bandwidth.shape == (50,)


# ---------------------------------------------------------------------------
# api: spec floors and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rel_step_floor_matches(dtype):
    assert tspec.rel_step_floor(getattr(torch, dtype)) == \
        jspec.rel_step_floor(dtype) == tspec.rel_step_floor(dtype)


@pytest.mark.parametrize("bad", [dict(tol=0.0), dict(tol=1e-6, dtype="float32"),
                                 dict(tol=1e-20), dict(sp1_method="newton"),
                                 dict(sp2_method="cvx"), dict(max_iters=-1),
                                 dict(sp2_iters=0), dict(dtype="float16")])
def test_spec_validation_matches(bad):
    with pytest.raises(ValueError):
        jspec.SolverSpec(**bad)
    with pytest.raises(ValueError):
        tspec.SolverSpec(**bad)


@pytest.mark.parametrize("w, cells", [
    (JWeights(0.3, 0.5, 2.0), None), (JWeights(0.3, 0.5, 2.0), 3),
    ([JWeights(0.5, 0.5, 1.0), JWeights(0.9, 0.1, 1.0)], 2),
    (np.array([[1.0, 3.0, 2.0], [2.0, 2.0, 1.0]]), 2)])
def test_weights_leaf_matches(w, cells):
    ref = jweights_leaf(w, np.float64, cells=cells)
    if isinstance(w, JWeights):
        w = TWeights(w.w1, w.w2, w.rho)
    elif isinstance(w, list):
        w = [TWeights(x.w1, x.w2, x.rho) for x in w]
    ours = tweights_leaf(w, torch.float64, "cpu", cells=cells)
    close(ours, ref, 1e-15)
    with pytest.raises(ValueError):
        tweights_leaf(np.array([[1.0, -1.0, 1.0]]), torch.float64, "cpu", 1)


# ---------------------------------------------------------------------------
# SP1: the sweep engine
# ---------------------------------------------------------------------------

def sp1_inputs(seed, w):
    sj, st = cell(seed, 64, bw_per_device=4e5)
    B, p, _, _ = allocation(64, seed)
    B *= float(sj.bandwidth_total) / 20e6
    tt = np.asarray(sj.bits / jnp.maximum(jen.rate(sj, jnp.asarray(B),
                                                   jnp.asarray(p)), 1e-12))
    warr = np.array([w[0], max(w[1], 1e-9), w[2]]) / (w[0] + w[1])
    return sj, st, tt, warr


@pytest.mark.parametrize("w", [(0.5, 0.5, 1.0), (0.95, 0.05, 1.0),
                               (0.05, 0.95, 1.0), (0.5, 0.5, 30.0),
                               (0.0, 1.0, 1.0)])
def test_sp1_sweep_matches(w):
    sj, st, tt, warr = sp1_inputs(3, w)
    acc_j, acc_t = jacc.default_accuracy(), tacc.default_accuracy()
    fj, sj_, shj, Tj = jsp1._solve_sp1_sweep_impl(
        sj, jnp.asarray(warr), acc_j, jnp.asarray(tt))
    ft, st_, sht, Tt = tsp1._solve_sp1_sweep_impl(
        st.batched(), torch.tensor(warr)[None], acc_t, torch.tensor(tt)[None])
    close(Tt, Tj, 1e-10)
    close(ft, fj, 1e-10)
    close(sht, shj, 1e-10)
    np.testing.assert_array_equal(st_[0].numpy(), np.asarray(sj_))


def test_sp1_sweep_batches_cells():
    """Three cells with their own systems and weights in one batch equal
    three reference solves."""
    ws = [(0.5, 0.5, 1.0), (0.9, 0.1, 2.0), (0.0, 1.0, 1.0)]
    ins = [sp1_inputs(seed, w) for seed, w in zip((4, 5, 6), ws)]
    batch = tbcd.stack_systems([x[1] for x in ins])
    f, s, s_hat, T = tsp1._solve_sp1_sweep_impl(
        batch, torch.tensor(np.stack([x[3] for x in ins])),
        tacc.default_accuracy(), torch.tensor(np.stack([x[2] for x in ins])))
    for c, (sj, _, tt, warr) in enumerate(ins):
        ref = jsp1._solve_sp1_sweep_impl(sj, jnp.asarray(warr),
                                         jacc.default_accuracy(),
                                         jnp.asarray(tt))
        for ours, r in zip((f[c], s_hat[c], T[c, 0]), (ref[0], ref[2], ref[3])):
            close(ours, r, 1e-10)
        np.testing.assert_array_equal(s[c].numpy(), np.asarray(ref[1]))


def test_sp1_helpers_match():
    sj, st = cell()
    shat = np.linspace(150.0, 650.0, 50)
    np.testing.assert_array_equal(
        tsp1.round_resolution(st, torch.tensor(shat)).numpy(),
        np.asarray(jsp1.round_resolution(sj, jnp.asarray(shat))))
    acc_j, acc_t = jacc.default_accuracy(), tacc.default_accuracy()
    assert tsp1.dual_evals_per_iter("sweep", acc_t) == \
        jsp1.dual_evals_per_iter("sweep", acc_j)
    lam = np.geomspace(1e-3, 1e6, 50)
    wj, wt = JWeights(0.5, 0.5, 1.0), TWeights(0.5, 0.5, 1.0)
    close(tsp1._f_of_lambda(st, wt, torch.tensor(lam)),
          jsp1._f_of_lambda(sj, wj, jnp.asarray(lam)), 1e-14)
    close(tsp1._s_of_lambda(st, wt, acc_t, torch.tensor(lam)),
          jsp1._s_of_lambda(sj, wj, acc_j, jnp.asarray(lam)), 1e-14)


def test_sp1_geomspace_matches_jnp():
    lo, hi = np.array([[0.0123], [3.5]]), np.array([[4.2e3], [1e9]])
    ours = tsp1._geomspace(torch.tensor(lo), torch.tensor(hi), 16).numpy()
    for c in range(2):
        ref = np.asarray(jnp.geomspace(jnp.asarray(lo[c, 0]),
                                       jnp.asarray(hi[c, 0]), 16))
        np.testing.assert_allclose(ours[c], ref, rtol=1e-14)   # a few ulps


# ---------------------------------------------------------------------------
# SP2: the direct engine
# ---------------------------------------------------------------------------

def rmin_of(seed, n=64, slack=(1.2, 3.0)):
    """A rate floor from a deadline `slack` times each device's compute."""
    sj, st = cell(seed, n, bw_per_device=4e5)
    rng = np.random.default_rng(seed)
    _, _, f, s = allocation(n, seed)
    t_cmp = np.asarray(jen.t_cmp(sj, jnp.asarray(f), jnp.asarray(s)))
    T = t_cmp.max() * rng.uniform(*slack)
    rmin = np.asarray(jsp2.r_min(sj, jnp.asarray(f), jnp.asarray(s),
                                 jnp.asarray(T)))
    return sj, st, rmin, (f, s, T)


def test_sp2_building_blocks_match():
    sj, st, rmin, (f, s, T) = rmin_of(7)
    b = st.batched()
    B = np.random.default_rng(7).uniform(1e3, 2e6, 64)
    jr, tr = jnp.asarray(rmin), torch.tensor(rmin)[None]
    jB, tB = jnp.asarray(B), torch.tensor(B)[None]
    close(tsp2.r_min(b, torch.tensor(f)[None], torch.tensor(s)[None],
                     torch.tensor([[T]])), rmin, 1e-13)
    close(tsp2.G(b, torch.tensor(1e-2, dtype=torch.float64), tB), jsp2.G(sj, 1e-2, jB), 1e-13)
    close(tsp2._clamp_rmin(b, tr), jsp2._clamp_rmin(sj, jr), 1e-13)
    close(tsp2._p_rate(b, tr, tB), jsp2._p_rate(sj, jr, jB), 1e-12)
    close(tsp2._denergy_dB(b, tr, tB), jsp2._denergy_dB(sj, jr, jB), 1e-12)
    close(tsp2._denergy2_dB2(b, tr, tB), jsp2._denergy2_dB2(sj, jr, jB), 1e-12)
    close(tsp2._b_min(b, tsp2._clamp_rmin(b, tr)),
          jsp2._b_min(sj, jsp2._clamp_rmin(sj, jr)), 1e-12)
    assert tsp2._search_iters(torch.float32) == jsp2._search_iters(jnp.float32)
    assert tsp2._search_iters(torch.float64) == jsp2._search_iters(jnp.float64)


# the dual search's eval count rides data-dependent exits; XLA's fused
# arithmetic moves them by a few evaluations (ROADMAP.md Queue 3)
EV_SLACK = 6


@pytest.mark.parametrize("seed, slack", [(7, (1.2, 3.0)), (8, (1.05, 1.1)),
                                         (9, (5.0, 20.0)), (10, (1.5, 2.0))])
def test_sp2_direct_matches(seed, slack):
    sj, st, rmin, _ = rmin_of(seed, slack=slack)
    pj, Bj, evj = jsp2._sp2_direct_impl(sj, jnp.asarray(rmin))
    pt, Bt, evt = tsp2._sp2_direct_impl(st.batched(), torch.tensor(rmin)[None])
    close(pt, pj, 1e-9)
    close(Bt, Bj, 1e-9)
    assert evt.dtype == torch.int32 and evt.shape == (1,)
    assert abs(int(evt[0]) - int(evj)) <= EV_SLACK


def test_sp2_direct_batches_cells():
    """Cells with different floors and budgets in one batch: each keeps its
    own exits (vmap-of-while semantics), so each equals its own solve."""
    ins = [rmin_of(seed, slack=sl) for seed, sl in
           ((11, (1.2, 3.0)), (12, (1.05, 1.1)), (13, (5.0, 20.0)))]
    batch = tbcd.stack_systems([x[1] for x in ins])
    p, B, ev = tsp2._sp2_direct_impl(
        batch, torch.tensor(np.stack([x[2] for x in ins])))
    for c, (_, st, rmin, _) in enumerate(ins):
        p1, B1, ev1 = tsp2._sp2_direct_impl(st.batched(),
                                            torch.tensor(rmin)[None])
        close(p[c], p1[0], 1e-13)
        close(B[c], B1[0], 1e-13)
        assert int(ev[c]) == int(ev1[0])


# ---------------------------------------------------------------------------
# BCD loop: per-cell convergence and the ledger
# ---------------------------------------------------------------------------

RATES = np.array([0.5, 0.1, 0.02, 0.7])


def test_bcd_while_freezes_each_cell_like_vmap():
    """A synthetic contraction whose rate differs per cell: cells converge
    at different iterations, and each cell's ledger, iterate count and
    frozen state equal the reference `_bcd_while` under `jax.vmap`."""
    C, N, max_iters, tol = 4, 5, 12, 1e-6
    x0 = np.random.default_rng(0).uniform(1.0, 2.0, (C, N))

    def jstep_for(r):
        def step(state):
            new = tuple(1.0 + r * (x - 1.0) for x in state[:5]) + state[5:]
            return new, (jnp.sum(new[0]), jnp.asarray(7.0))
        return step

    def jsolve(x, r):
        state0 = (x, x, x, x, x, jnp.zeros(()))
        return jbcd._bcd_while(state0, max_iters, 3, tol, jstep_for(r))

    ref = jax.vmap(jsolve)(jnp.asarray(x0), jnp.asarray(RATES))
    r = torch.tensor(RATES)[:, None]

    def tstep(state):
        new = tuple(1.0 + r * (x - 1.0) for x in state[:5]) + state[5:]
        return new, (new[0].sum(-1), torch.full((C,), 7.0,
                                                 dtype=torch.float64))

    x = torch.tensor(x0)
    ours = tbcd._bcd_while((x, x, x, x, x, torch.zeros(C, 1)), max_iters, 3,
                           tol, tstep)
    np.testing.assert_array_equal(ours[6].numpy(), np.asarray(ref[6]))
    np.testing.assert_array_equal(ours[7].numpy(), np.asarray(ref[7]))
    np.testing.assert_allclose(ours[8].numpy(), np.asarray(ref[8]),
                               rtol=1e-12, equal_nan=True)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-14)
    counters = tbcd._pack_counters(ours[6], ours[8], max_iters, 1, 2, 49)
    ref_c = jax.vmap(lambda i, l: jbcd._pack_counters(i, l, max_iters, 1, 2,
                                                      49))(ref[6], ref[8])
    np.testing.assert_allclose(counters.numpy(), np.asarray(ref_c),
                               rtol=1e-12)


def test_initial_allocation_matches():
    sj, st = cell()
    aj, at = jbcd.initial_allocation(sj), tbcd.initial_allocation(st)
    for x, y in zip(at.astuple(), aj.astuple()):
        close(x, y, 1e-15)
        assert x.shape == (50,)
