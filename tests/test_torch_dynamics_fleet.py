"""`repro_torch.solve(Problem(rounds=...))` on a 3-cell fleet against
`repro.solve` on the CPU, for every channel mode x participation model
with dropout: the port fed the reference's draws (cell c draws from
split(key, 3)[c], as `repro/api/solve.py::_solve_rounds_fleet` splits),
the ledgers, staleness codes and gains compared as in
tests/test_torch_dynamics.py; and a padded fleet's pad lanes."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

import repro
from repro import dynamics as dyn_j
from repro.region.batch import pad_system as pad_j

import repro_torch as rt
from repro_torch.dynamics import ROUND_COLS, RoundsConfig

from _torch_rounds import compare_rounds, reference_draws, to_port

W = [(0.5, 0.5, 1.0), (0.3, 0.7, 0.5), (0.8, 0.2, 1.0)]
PAIRS = list(itertools.product(("static", "iid", "markov"),
                               ("full", "drop", "stale")))


@pytest.fixture(scope="module")
def fleet():
    fj = repro.make_fleet(jax.random.PRNGKey(14), n_cells=3, n_devices=8)
    return fj, to_port(fj)


@pytest.mark.parametrize("mode,participation", PAIRS)
def test_engine_matches_repro_fleet(fleet, mode, participation):
    fj, ft = fleet
    kw = dict(rounds=4, channel_mode=mode, participation=participation,
              dropout_prob=0.2, deadline_slack=0.98, max_staleness=3)
    key = jax.random.PRNGKey(15)
    rj = repro.solve(repro.Problem(system=fj,
                                   weights=[repro.Weights(*w) for w in W],
                                   rounds=dyn_j.RoundsConfig(**kw), key=key))
    cfg = RoundsConfig(**kw)
    rr = rt.solve(rt.Problem(system=ft, weights=[rt.Weights(*w) for w in W],
                             rounds=cfg,
                             key=reference_draws(key, 8, cfg, jnp.float64,
                                                 cells=3)))
    assert rr.ledger.shape == (3, 4, len(ROUND_COLS))
    assert rr.staleness.shape == (3, 4, 8)
    compare_rounds(rr, rj, cfg)


def test_padded_fleet_rounds():
    """Two cells of 6 and 8 devices padded to 8: pad lanes never
    participate (code -1, counted dropped), get B = 0, and the ledger
    matches repro's padded fleet."""
    cells = [repro.make_system(jax.random.PRNGKey(k), n_devices=n)
             for k, n in ((1, 6), (2, 8))]
    fj = repro.stack_systems([pad_j(c, 8) for c in cells])
    ft = to_port(fj)
    kw = dict(rounds=3, channel_mode="iid", participation="stale",
              dropout_prob=0.1, deadline_slack=0.98)
    key = jax.random.PRNGKey(3)
    rj = repro.solve(repro.Problem(system=fj, weights=repro.Weights(*W[0]),
                                   rounds=dyn_j.RoundsConfig(**kw), key=key))
    cfg = RoundsConfig(**kw)
    rr = rt.solve(rt.Problem(system=ft, weights=rt.Weights(*W[0]), rounds=cfg,
                             key=reference_draws(key, 8, cfg, jnp.float64,
                                                 cells=2)))
    compare_rounds(rr, rj, cfg)
    assert bool((rr.staleness[0, :, 6:] == -1).all())
    assert torch.equal(rr.allocation.bandwidth[0, 6:],
                       torch.zeros(2, dtype=torch.float64))
    assert bool((rr.col("n_dropped")[0] >= 2).all())
