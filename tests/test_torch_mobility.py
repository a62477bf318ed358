"""`repro_torch.dynamics.mobility` against `repro.dynamics.mobility` on the
CPU: both position models and `trace_gains` fed the reference's own
`jax.random` draws (rebuilt here by splitting the key as
`repro/dynamics/mobility.py::_trace_impl` does, and carried over through
`interop.mobility_draws_from_numpy`), in float32 and float64; shapes,
invariants and determinism of the port's own generator's traces.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

import repro
from repro.assoc import bs_grid as bs_grid_j
from repro.dynamics import MobilityConfig as MobilityConfig_j

from repro_torch import interop
from repro_torch.dynamics import (MobilityConfig, mobility_draws,
                                  simulate_mobility, trace_gains)
from repro_torch.dynamics.mobility import bs_grid

# relative to each array's largest value. Measured: <= 4.1e-15 in float64
# and <= 1.2e-6 in float32 (torch's pow / log10 / exp and XLA's differ in
# the last bit, and 10^(-pl/10) amplifies the pathloss's rounding)
TOL = {"float64": 1e-13, "float32": 1e-5}


def reference_draws(key, n, n_cells, cfg, dtype):
    """The draws `repro.simulate_mobility(key, ...)` makes, as numpy."""
    kp, kg = jax.random.split(key)
    out = {}
    if cfg.model == "rwp":
        k0, k1, k2, ks = jax.random.split(kp, 4)
        out["pos0"] = jax.random.uniform(k0, (n, 2), dtype)
        out["wp0"] = jax.random.uniform(k1, (n, 2), dtype)
        out["v0"] = jax.random.uniform(k2, (n,), dtype)
        xy, v = [], []
        for kr in jax.random.split(ks, cfg.steps):
            kw, kv = jax.random.split(kr)
            xy.append(jax.random.uniform(kw, (n, 2), dtype))
            v.append(jax.random.uniform(kv, (n,), dtype))
        out["step_xy"], out["step_v"] = np.stack(xy), np.stack(v)
    else:
        k0, kv, ks = jax.random.split(kp, 3)
        out["pos0"] = jax.random.uniform(k0, (n, 2), dtype)
        out["v0"] = jax.random.normal(kv, (n, 2), dtype)
        out["step_xy"] = np.stack([jax.random.normal(kr, (n, 2), dtype)
                                   for kr in jax.random.split(ks,
                                                              cfg.steps)])
    if cfg.shadowing_db != 0.0:
        k0, ks = jax.random.split(kg)
        out["shadow0"] = jax.random.normal(k0, (n_cells, n), dtype)
        out["shadow_z"] = np.stack([
            jax.random.normal(kr, (n_cells, n), dtype)
            for kr in jax.random.split(ks, cfg.steps - 1)])
    return {k: np.asarray(v) for k, v in out.items()}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("model", ["rwp", "gauss_markov"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n_cells", [1, 4])
def test_trace_matches_repro(model, dtype, n_cells):
    kw = dict(model=model, steps=12, area_m=500.0, v_max=20.0)
    cfg_j, cfg = MobilityConfig_j(**kw), MobilityConfig(**kw)
    key = jax.random.PRNGKey(7)
    n = 10
    tj = repro.simulate_mobility(key, n_devices=n, n_cells=n_cells, cfg=cfg_j,
                                 dtype=dtype)
    draws = interop.mobility_draws_from_numpy(
        reference_draws(key, n, n_cells, cfg_j, jnp.dtype(dtype)),
        device="cpu")
    tt = simulate_mobility(draws, n, n_cells, cfg, dtype=getattr(torch, dtype),
                           device="cpu")
    assert tt.positions.dtype == getattr(torch, dtype)
    assert rel(tt.positions, tj.positions) <= TOL[dtype]
    assert rel(tt.gains, tj.gains) <= TOL[dtype]
    np.testing.assert_array_equal(tt.bs_xy.numpy(), np.asarray(tj.bs_xy))
    np.testing.assert_array_equal(tt.serving.numpy(), np.asarray(tj.serving))
    np.testing.assert_array_equal(tt.handover.numpy(),
                                  np.asarray(tj.handover))


@pytest.mark.parametrize("model", ["rwp", "gauss_markov"])
def test_trace_shapes_and_invariants(model):
    cfg = MobilityConfig(model=model, steps=8, area_m=500.0)
    tr = simulate_mobility(3, n_devices=12, n_cells=3, cfg=cfg, device="cpu")
    R, C, N = cfg.steps, 3, 12
    assert tr.positions.shape == (R, N, 2)
    assert tr.gains.shape == (R, C, N)
    assert tr.serving.shape == (R, N) and tr.handover.shape == (R, N)
    assert tr.steps == R and tr.n_cells == C
    assert bool((tr.positions.abs() <= cfg.area_m / 2 + 1e-6).all())
    g = tr.gains
    assert bool(torch.isfinite(g).all() and (g > 0).all())
    assert torch.equal(tr.serving, g.argmax(1).to(torch.int32))
    assert not tr.handover[0].any()
    assert torch.equal(tr.handover[1:], tr.serving[1:] != tr.serving[:-1])
    # same seed, same trace; another seed moves it
    again = simulate_mobility(3, n_devices=12, n_cells=3, cfg=cfg,
                              device="cpu")
    for name in ("positions", "gains", "serving", "handover"):
        assert torch.equal(getattr(tr, name), getattr(again, name)), name
    other = simulate_mobility(4, n_devices=12, n_cells=3, cfg=cfg,
                              device="cpu")
    assert not torch.equal(tr.positions, other.positions)


def test_trace_gains_pathloss_and_grid():
    cfg = MobilityConfig(shadowing_db=0.0, steps=2)
    pos = torch.zeros((2, 5, 2), dtype=torch.float64)
    bs = bs_grid(2, 1000.0, torch.float64)
    np.testing.assert_array_equal(bs.numpy(),
                                  np.asarray(bs_grid_j(2, 1000.0,
                                                       jnp.float64)))
    g = trace_gains(pos, bs, cfg)
    assert torch.equal(g[0], g[1])
    gj = repro.dynamics.mobility.trace_gains(
        jax.random.PRNGKey(0), jnp.zeros((2, 5, 2)), bs_grid_j(2, 1000.0,
                                                              jnp.float64),
        MobilityConfig_j(shadowing_db=0.0, steps=2))
    assert rel(g, gj) <= TOL["float64"]
    with pytest.raises(ValueError, match="shadow"):
        trace_gains(pos, bs, MobilityConfig(steps=2))


def test_mobility_config_validation():
    with pytest.raises(ValueError, match="model"):
        MobilityConfig(model="teleport")
    with pytest.raises(ValueError, match="steps"):
        MobilityConfig(steps=0)
    with pytest.raises(ValueError, match="v_max"):
        MobilityConfig(v_min=3.0, v_max=2.0)
    with pytest.raises(ValueError, match="alpha"):
        MobilityConfig(alpha=1.5)
    with pytest.raises(ValueError):
        simulate_mobility(0, n_devices=4, n_cells=2,
                          bs_xy=torch.zeros((3, 2)), device="cpu")
    d = mobility_draws(0, 4, 2, MobilityConfig(), device="cpu")
    with pytest.raises(ValueError, match="devices"):
        simulate_mobility(d, n_devices=5, n_cells=2, device="cpu")
