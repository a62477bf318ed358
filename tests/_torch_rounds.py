"""Shared helpers of the round-dynamics parity tests: systems carried over
from `repro`, and the reference's `jax.random` draws rebuilt by splitting
the key exactly as `repro/api/solve.py::_solve_rounds_fleet` and
`repro/dynamics/engine.py::_cell_engine` do."""
import jax
import jax.numpy as jnp
import numpy as np

from repro.core.types import _SYS_ARRAYS, _SYS_SCALARS

from repro_torch import interop
from repro_torch.dynamics import ROUND_COLS

# the SP2 dual search's eval count rides data-dependent exits that XLA's
# fused arithmetic moves by up to 7 evaluations per BCD iteration (ROADMAP
# Queue 3, tests/test_torch_solve.py)
EV_SLACK_PER_ITER = 8
# every ledger column but the eval count, relative to the column's scale
LEDGER_TOL = 1e-9


def to_port(sj, dtype=None):
    leaves = {k: np.asarray(getattr(sj, k)) for k in _SYS_ARRAYS + _SYS_SCALARS}
    if sj.active is not None:
        leaves["active"] = np.asarray(sj.active)
    return interop.system_from_numpy(leaves, sj.resolutions, device="cpu",
                                     dtype=dtype)


def cell_draws(key, n, cfg, dtype):
    """One cell's (shadow0 (N,), z (R, N), drop (R, N)) as the reference's
    `_cell_engine` draws them from `key`."""
    k_shadow, k_rounds = jax.random.split(key)
    shadow0 = jax.random.normal(k_shadow, (n,), dtype) \
        if cfg.channel_mode == "markov" else jnp.zeros((n,), dtype)
    z, drop = [], []
    for kr in jax.random.split(k_rounds, cfg.rounds):
        k_gain, k_drop = jax.random.split(kr)
        z.append(jax.random.normal(k_gain, (n,), dtype))
        drop.append(jax.random.bernoulli(k_drop, cfg.dropout_prob, (n,))
                    if cfg.dropout_prob > 0.0 else jnp.zeros((n,), bool))
    return np.asarray(shadow0), np.stack(z), np.stack(drop)


def reference_draws(key, n, cfg, dtype, cells=None):
    """`RoundDraws` of the reference's rounds solve with `key`: one cell
    (cells=None) or `cells` cells, cell c drawing from split(key, C)[c]."""
    if cells is None:
        sh, z, d = cell_draws(key, n, cfg, dtype)
    else:
        parts = [cell_draws(k, n, cfg, dtype)
                 for k in jax.random.split(key, cells)]
        sh, z, d = (np.stack(x) for x in zip(*parts))
    return interop.round_draws_from_numpy(sh, z, d, device="cpu")


def compare_rounds(rr, rj, cfg):
    """Port RoundsResult vs repro's (either topology): BCD iterations,
    convergence, staleness codes and dropped / late counts exactly; gains,
    resolutions and the other ledger columns to LEDGER_TOL; sp2_evals
    within EV_SLACK_PER_ITER per BCD iteration of the round, or within the
    slack repro allows between its own single-cell and fleet lowerings of
    one round (tests/test_dynamics.py::test_fleet_matches_per_cell_runs:
    a flipped Newton exit in a warm-started round moves the count by a
    whole inner search)."""
    lj, lt = np.asarray(rj.ledger), rr.ledger.numpy()
    assert lt.shape == lj.shape
    for i, c in enumerate(ROUND_COLS):
        a, b = lt[..., i], lj[..., i]
        if c in ("bcd_iters", "bcd_converged", "n_late", "n_dropped"):
            np.testing.assert_array_equal(a, b, err_msg=c)
        elif c == "sp2_evals":
            iters = lj[..., ROUND_COLS.index("bcd_iters")]
            gap = np.abs(a - b)
            assert np.all((gap <= EV_SLACK_PER_ITER * iters)
                          | (gap <= 8 + 0.2 * np.abs(b))), (c, a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=LEDGER_TOL,
                                       atol=LEDGER_TOL * np.abs(b).max(),
                                       err_msg=c)
    np.testing.assert_array_equal(rr.staleness.numpy(),
                                  np.asarray(rj.staleness))
    np.testing.assert_allclose(rr.gains.numpy(), np.asarray(rj.gains),
                               rtol=1e-12)
    np.testing.assert_array_equal(rr.resolutions.numpy(),
                                  np.asarray(rj.resolutions))
    np.testing.assert_allclose(rr.allocation.bandwidth.numpy(),
                               np.asarray(rj.allocation.bandwidth),
                               rtol=1e-9)
    codes = rr.staleness.numpy()
    assert codes.min() >= -1 and codes.max() <= cfg.max_staleness
