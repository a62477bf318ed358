"""`repro_torch.dynamics` (the round-dynamics engine) against
`repro.dynamics` on the CPU, single cell: the engine fed the reference's
own `jax.random` draws (`interop.round_draws_from_numpy`) for every
channel mode x participation model with dropout, the participation
primitives, the static / full configuration against the port's own
allocate-once ledger, warm against cold re-allocation, and the port's own
generator's draws on their statistics. The 3-cell fleet is in
tests/test_torch_dynamics_fleet.py.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

import repro
from repro import dynamics as dyn_j

import repro_torch as rt
from repro_torch.core.energy import e_cmp, e_trans, t_cmp, t_trans
from repro_torch.dynamics import (ROUND_COLS, RoundsConfig,
                                  draws_from_generator, queue_step,
                                  staleness_of)

from _torch_rounds import compare_rounds, reference_draws, to_port

W = (0.5, 0.5, 1.0)
PAIRS = list(itertools.product(("static", "iid", "markov"),
                               ("full", "drop", "stale")))

@pytest.fixture(scope="module")
def cell():
    sj = repro.make_system(jax.random.PRNGKey(0), n_devices=8)
    return sj, to_port(sj)


@pytest.mark.parametrize("mode,participation", PAIRS)
def test_engine_matches_repro_single(cell, mode, participation):
    sj, st = cell
    kw = dict(rounds=4, channel_mode=mode, participation=participation,
              dropout_prob=0.2, deadline_slack=0.98, max_staleness=3)
    key = jax.random.PRNGKey(7)
    rj = repro.solve(repro.Problem(system=sj, weights=repro.Weights(*W),
                                   rounds=dyn_j.RoundsConfig(**kw), key=key))
    cfg = RoundsConfig(**kw)
    draws = reference_draws(key, 8, cfg, jnp.float64)
    rr = rt.solve(rt.Problem(system=st, weights=rt.Weights(*W), rounds=cfg,
                             key=draws))
    assert rr.ledger.shape == (4, len(ROUND_COLS))
    compare_rounds(rr, rj, cfg)


def test_staleness_and_queue_match_repro():
    rng = np.random.default_rng(5)
    t = rng.uniform(0.0, 10.0, (3, 40))
    d = rng.uniform(0.5, 3.0, (3, 1))
    # devices exactly on and one ulp around bucket edges
    t[:, :3] = d * np.array([1.0, 2.0, 3.0])
    t[:, 3:6] = np.nextafter(t[:, :3], np.inf)
    k = staleness_of(torch.tensor(t), torch.tensor(d), 4)
    for c in range(3):
        kj = dyn_j.staleness_of(jnp.asarray(t[c]), jnp.asarray(d[c, 0]), 4)
        np.testing.assert_array_equal(k[c].numpy(), np.asarray(kj))
    assert k.dtype == torch.int32
    # the reference's own bucket check
    kk = staleness_of(torch.tensor([[0.5, 2.0, 2.1, 4.0, 4.1, 100.0]]),
                      torch.tensor([[2.0]]), 3)
    assert kk.tolist() == [[0, 0, 1, 1, 2, 3]]

    K, N = 4, 40
    qw, qu = rng.uniform(0, 5, (3, K)), rng.uniform(0, 5, (3, K))
    idx = rng.integers(0, K, (3, N))
    pw, pu = rng.uniform(0, 5, (3, N)), rng.uniform(0, 5, (3, N))
    out = queue_step(*(torch.tensor(x) for x in (qw, qu, idx, pw, pu)))
    for c in range(3):
        ref = dyn_j.queue_step(*(jnp.asarray(x[c]) for x in
                                 (qw, qu, idx.astype(np.int32), pw, pu)))
        for a, b in zip(out, ref):
            # the scatter-add sums up to N pushes per slot; its order is not
            # XLA's (measured: <= 1 ulp of the slot's sum)
            np.testing.assert_allclose(a[c].numpy(), np.asarray(b),
                                       rtol=4e-16)
    # mass conservation: popped + kept == old total + pushed
    qw2, _, pop_w, _ = out
    np.testing.assert_allclose((pop_w + qw2.sum(-1)).numpy(),
                               qw.sum(-1) + pw.sum(-1), rtol=1e-14)


def test_config_and_api_validation(cell):
    _, st = cell
    with pytest.raises(ValueError):
        RoundsConfig(channel_mode="rayleigh")
    with pytest.raises(ValueError):
        RoundsConfig(participation="sometimes")
    with pytest.raises(ValueError):
        RoundsConfig(rounds=0)
    with pytest.raises(ValueError):
        RoundsConfig(drift_rho=1.5)
    with pytest.raises(ValueError):
        RoundsConfig(dropout_prob=1.0)
    with pytest.raises(ValueError):
        RoundsConfig(bcd_iters=0, warm_start=False)
    w = rt.Weights(*W)
    cfg = RoundsConfig(rounds=2, bcd_iters=0, participation="drop")
    with pytest.raises(ValueError, match="makespan T"):
        rt.solve(rt.Problem(system=st, weights=w, rounds=cfg, key=0))
    bad = rt.Allocation(st.gain, st.gain, st.gain, st.gain)   # T=None
    with pytest.raises(ValueError, match="makespan T"):
        rt.solve(rt.Problem(system=st, weights=w, rounds=cfg, key=0,
                            init=bad))
    ok = RoundsConfig(rounds=2)
    with pytest.raises(ValueError, match="exclusive"):
        rt.solve(rt.Problem(system=st, weights=w, rounds=ok, key=0,
                            deadline=10.0))
    with pytest.raises(ValueError, match="needs problem.key"):
        rt.solve(rt.Problem(system=st, weights=w, rounds=ok))
    with pytest.raises(ValueError, match="RoundsConfig"):
        rt.solve(rt.Problem(system=st, weights=w, rounds=ok, key=0),
                 rt.SolverSpec(max_iters=3))
    # rounds over a mesh are ported, for a stacked (C, N) system only
    with pytest.raises(ValueError, match="mesh requires a stacked"):
        rt.solve(rt.Problem(system=st, weights=w, rounds=ok, key=0,
                            mesh=object()))
    with pytest.raises(ValueError, match="RoundDraws.z"):
        rt.solve(rt.Problem(system=st, weights=w, rounds=ok,
                            key=draws_from_generator(0, 1, 3, 8, ok,
                                                     device="cpu")))


def per_round(sysp, alloc):
    e = float((e_trans(sysp, alloc.bandwidth, alloc.power)
               + e_cmp(sysp, alloc.freq, alloc.resolution)).sum())
    t = float((t_cmp(sysp, alloc.freq, alloc.resolution)
               + t_trans(sysp, alloc.bandwidth, alloc.power)).max())
    return e, t


@pytest.mark.parametrize("sp1_method", ["sweep", "bisect"])
def test_static_parity_with_allocate_once(cell, sp1_method):
    """static channel / full participation reproduces the port's own
    allocate-once ledger (tests/test_dynamics.py:33-56)."""
    _, st = cell
    res = rt.solve(rt.Problem(system=st, weights=rt.Weights(*W)),
                   rt.SolverSpec(max_iters=8, sp1_method=sp1_method))
    e_ref, t_ref = per_round(st, res.allocation)
    cfg = RoundsConfig(rounds=4, bcd_iters=8, sp1_method=sp1_method)
    rr = rt.solve(rt.Problem(system=st, weights=rt.Weights(*W), rounds=cfg,
                             key=1))
    np.testing.assert_allclose(rr.col("energy").numpy(), e_ref, rtol=1e-5)
    np.testing.assert_allclose(rr.col("time").numpy(), t_ref, rtol=1e-5)
    assert bool((rr.col("arrived_frac") == 1.0).all())
    assert bool((rr.col("n_late") == 0).all())
    assert bool((rr.staleness == 0).all())
    assert torch.equal(rr.gains, st.gain.expand(4, 8))
    assert rr.resolutions.shape == (4, 8)
    assert torch.equal(rr.resolutions,
                       rr.allocation.resolution.expand(4, 8))
    # bcd_iters=0 simulates the init unchanged
    sim = rt.solve(rt.Problem(system=st, weights=rt.Weights(*W),
                              rounds=RoundsConfig(rounds=3, bcd_iters=0),
                              key=2, init=res.allocation))
    np.testing.assert_allclose(sim.col("energy").numpy(), e_ref, rtol=1e-12)
    np.testing.assert_allclose(sim.col("time").numpy(), t_ref, rtol=1e-12)
    assert bool((sim.col("bcd_iters") == 0).all())


def test_warm_rounds_spend_fewer_sp2_evals(cell):
    """Warm-started re-allocation under correlated fading spends fewer SP2
    evals than a cold re-solve every round (and no more BCD iterations),
    in the port as in repro."""
    sj, st = cell
    key = jax.random.PRNGKey(21)
    out = {}
    for warm in (True, False):
        kw = dict(rounds=6, channel_mode="markov", drift_rho=0.95,
                  warm_start=warm)
        cfg = RoundsConfig(**kw)
        rr = rt.solve(rt.Problem(system=st, weights=rt.Weights(*W),
                                 rounds=cfg,
                                 key=reference_draws(key, 8, cfg,
                                                     jnp.float64)))
        rj = repro.solve(repro.Problem(system=sj, weights=repro.Weights(*W),
                                       rounds=dyn_j.RoundsConfig(**kw),
                                       key=key))
        compare_rounds(rr, rj, cfg)
        out[warm] = rr
    warm, cold = out[True], out[False]
    # round 0 starts from the same cold init either way
    assert float(warm.col("sp2_evals")[1:].sum()) \
        < float(cold.col("sp2_evals")[1:].sum())
    assert float(warm.col("bcd_iters")[1:].sum()) \
        <= float(cold.col("bcd_iters")[1:].sum())


def test_generator_draws_statistics():
    """The port's own draws (a seeded torch.Generator): iid shadowing
    keeps E[gain] and the lognormal spread, Markov drift correlates
    round to round at about drift_rho, dropout marks devices lost."""
    st = rt.make_system(4, n_devices=64, device="cpu", dtype=torch.float64)
    w = rt.Weights(*W)
    init = rt.solve(rt.Problem(system=st, weights=w),
                    rt.SolverSpec(max_iters=4)).allocation
    sigma = 8.0 * np.log(10.0) / 10.0
    logs = {}
    for mode, rho in (("iid", 0.0), ("markov", 0.95)):
        cfg = RoundsConfig(rounds=32, channel_mode=mode, drift_rho=rho,
                           bcd_iters=0, dropout_prob=0.25)
        rr = rt.solve(rt.Problem(system=st, weights=w, rounds=cfg, key=9,
                                 init=init))
        logs[mode] = np.log(rr.gains.numpy()) - np.log(st.gain.numpy())
        dropped = rr.staleness.numpy() == -1
        assert abs(dropped.mean() - 0.25) < 0.05
        np.testing.assert_array_equal(rr.col("n_dropped").numpy(),
                                      dropped.sum(-1))
    g = logs["iid"]
    # lognormal: E[log g] = log E[g] - sigma^2/2, std[log g] = sigma
    assert abs(g.mean() + sigma ** 2 / 2) < 5 * sigma / np.sqrt(g.size)
    assert abs(g.std() - sigma) < 0.1 * sigma

    def lag1(x):   # mean per-device lag-1 autocorrelation of log-gain
        d = x - x.mean(axis=0, keepdims=True)
        return float(np.mean((d[1:] * d[:-1]).sum(0)
                             / np.maximum((d * d).sum(0), 1e-30)))

    assert lag1(logs["markov"]) > 0.6
    assert abs(lag1(logs["iid"])) < 0.3
    # same seed, same draws
    cfg = RoundsConfig(channel_mode="markov", dropout_prob=0.1)
    a = draws_from_generator(3, 2, 4, 8, cfg, device="cpu")
    b = draws_from_generator(3, 2, 4, 8, cfg, device="cpu")
    assert torch.equal(a.z, b.z) and torch.equal(a.drop, b.drop)
