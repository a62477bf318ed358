"""The port's region mesh (`repro_torch.region.mesh`, `Problem.mesh`,
`SolverSpec.lockstep`) against the unsharded fleet solve and against
`repro`'s one-device mesh, on the CPU.

Mirrors tests/test_region.py without its forced-8-device subprocess: a
mesh here is the CPU device repeated D times (1 to 4), so D shards run
one after the other in this process. Sharding moves work, not math: the
per-cell results of a mesh solve, shard-local or lockstep, equal the
fleet solve's bit for bit.

CPU kernels compute the part of a tensor that does not fill a vector
register with scalar code, whose exp and log round differently from the
vector code, so a cell's bits could move with its position in a batch.
The shapes here keep every row whole: N is a multiple of 16 and every
batch holds fewer than 8 cells. On the card each element runs the same
code wherever it lies.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import repro
from repro.region import cell_specs as cell_specs_j

import repro_torch as rt
from repro_torch.api.solve import _allocate_impl
from repro_torch.region import cell_specs, pad_cells, region_mesh
from repro_torch.region.mesh import RegionMesh

from _torch_rounds import EV_SLACK_PER_ITER, to_port

W = rt.Weights(0.5, 0.5, 1.0)
SPEC = rt.SolverSpec(max_iters=6, tol=1e-5)
FIELDS = ("bandwidth", "power", "freq", "resolution", "s_relaxed", "T")
# (cells, mesh size): every mesh size 1..4, cells not a multiple of it
MESHES = [(5, 1), (5, 2), (5, 3), (3, 4)]


def fleet(C, N=16, seed=2):
    return rt.make_fleet(seed, C, N, device="cpu", dtype=torch.float64)


def cpu_mesh(D):
    return region_mesh(devices=["cpu"] * D)


def assert_same(res, base, fields=FIELDS):
    for f in fields:
        a, b = getattr(res.allocation, f), getattr(base.allocation, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    assert torch.equal(res.iters, base.iters)
    assert torch.equal(res.converged, base.converged)
    assert torch.equal(res.objective, base.objective)


@pytest.mark.parametrize("C, D", MESHES)
@pytest.mark.parametrize("lockstep", [False, True])
def test_mesh_matches_fleet_any_mesh(C, D, lockstep):
    f = fleet(C)
    base = rt.solve(rt.Problem(system=f, weights=W), SPEC)
    reg = rt.solve(rt.Problem(system=f, weights=W, mesh=cpu_mesh(D)),
                   SPEC.replace(lockstep=lockstep))
    assert isinstance(reg, rt.RegionResult)
    assert_same(reg, base)
    assert torch.equal(reg.fleet.history.nan_to_num(-1.0),
                       base.history.nan_to_num(-1.0))
    st = reg.stats
    assert st["cells"] == C and st["mesh_devices"] == D
    assert 0.0 <= st["converged_frac"] <= 1.0
    assert np.isfinite(st["objective_mean"])
    assert st["iters_max"] == int(base.iters.max())


def test_lockstep_runs_one_batch_shard_local_one_per_shard(monkeypatch):
    """Shard-local mode solves each shard's block as its own batch (its
    own exit); lockstep solves the padded cell axis as one batch, so every
    shard runs the global number of batched iterations."""
    calls = []

    def spy(sys, *a, **kw):
        calls.append(int(sys.gain.shape[0]))
        return _allocate_impl(sys, *a, **kw)

    # the module, not the `solve` function that repro_torch.api exports
    monkeypatch.setattr(sys.modules["repro_torch.api.solve"],
                        "_allocate_impl", spy)
    f = fleet(5, seed=5)
    out = {}
    for lockstep in (False, True):
        calls.clear()
        out[lockstep] = rt.solve(rt.Problem(system=f, weights=W,
                                            mesh=cpu_mesh(3)),
                                 SPEC.replace(lockstep=lockstep))
        out[lockstep, "calls"] = list(calls)
    assert out[False, "calls"] == [2, 2, 2]
    assert out[True, "calls"] == [6]
    assert_same(out[False], out[True])


def test_region_warm_start_init():
    f = fleet(3, seed=7)
    mesh = cpu_mesh(2)
    spec = rt.SolverSpec(max_iters=30, tol=1e-6)
    base = rt.solve(rt.Problem(system=f, weights=W, mesh=mesh), spec)
    warm = rt.solve(rt.Problem(system=f.replace(gain=f.gain * 1.02),
                               weights=W, mesh=mesh,
                               init=base.fleet.allocation), spec)
    assert bool(warm.converged.all())
    assert warm.stats["iters_max"] <= 3


@pytest.mark.parametrize("lockstep", [False, True])
def test_rounds_over_mesh_match_fleet(lockstep):
    f = fleet(5, seed=3)
    base = rt.solve(rt.Problem(system=f, weights=W), SPEC)
    cfg = rt.RoundsConfig(rounds=3, channel_mode="markov", bcd_iters=2,
                          participation="stale", dropout_prob=0.05)
    draws = rt.dynamics.draws_from_generator(7, 5, 3, 16, cfg, device="cpu",
                                             dtype=torch.float64)
    rf = rt.solve(rt.Problem(system=f, weights=W, rounds=cfg, key=draws,
                             init=base.allocation))
    rr = rt.solve(rt.Problem(system=f, weights=W, rounds=cfg, key=draws,
                             init=base.allocation, mesh=cpu_mesh(2)),
                  rt.SolverSpec(lockstep=lockstep))
    assert torch.equal(rr.ledger, rf.ledger)
    assert torch.equal(rr.staleness, rf.staleness)
    assert torch.equal(rr.gains, rf.gains)
    for f_ in FIELDS:
        assert torch.equal(getattr(rr.allocation, f_),
                           getattr(rf.allocation, f_)), f_
    with pytest.raises(ValueError, match="RoundsConfig"):
        rt.solve(rt.Problem(system=f, weights=W, rounds=cfg, key=draws,
                            mesh=cpu_mesh(2)), rt.SolverSpec(max_iters=3))


def test_mesh_deadline_matches_unsharded_fleet():
    """Scalar and per-cell deadlines over a mesh, both modes, bit for bit
    against the unsharded deadline fleet; the fixed-T ledger kept."""
    f = fleet(5, seed=7)
    per_cell = 120.0 + 10.0 * torch.arange(5, dtype=torch.float64)
    for deadline in (150.0, per_cell):
        base = rt.solve(rt.Problem(system=f, weights=W, deadline=deadline),
                        rt.SolverSpec(max_iters=5, tol=1e-5))
        for lockstep in (False, True):
            reg = rt.solve(rt.Problem(system=f, weights=W, deadline=deadline,
                                      mesh=cpu_mesh(2)),
                           rt.SolverSpec(max_iters=5, tol=1e-5,
                                         lockstep=lockstep))
            assert_same(reg, base, FIELDS[:4] + ("T",))
            assert reg.allocation.s_relaxed is None
            assert reg.fleet.columns == base.columns
            assert reg.stats["cells"] == 5


@pytest.mark.parametrize("lockstep", [False, True])
def test_region_stats_per_shard_counters_sum_to_fleet(lockstep):
    C, D = 5, 3
    f = fleet(C, seed=13)
    base = rt.solve(rt.Problem(system=f, weights=W), SPEC)
    ctr = base.counters.data.numpy()
    reg = rt.solve(rt.Problem(system=f, weights=W, mesh=cpu_mesh(D)),
                   SPEC.replace(lockstep=lockstep))
    st = reg.stats
    for k in ("shard_bcd_iters", "shard_sp1_evals", "shard_sp2_evals",
              "shard_residual_max"):
        assert len(st[k]) == D
    # the port's shards solve the same cells bit for bit, so every total
    # equals the fleet's exactly (the reference allows eval slack here)
    for col, key in ((0, "bcd_iters"), (1, "sp1_evals"), (2, "sp2_evals")):
        assert st[f"{key}_total"] == sum(st[f"shard_{key}"])
        assert st[f"{key}_total"] == float(np.nansum(ctr[:, col]))
    assert st["residual_max"] == float(np.nanmax(ctr[:, 3]))
    block = -(-C // D)
    blocks = np.concatenate([ctr, np.zeros((block * D - C, 4))]) \
        .reshape(D, block, 4)
    np.testing.assert_array_equal(st["shard_bcd_iters"],
                                  np.nansum(blocks[..., 0], 1))
    np.testing.assert_array_equal(st["shard_sp2_evals"],
                                  np.nansum(blocks[..., 2], 1))


def test_cell_specs_use_region_rules():
    from repro.core import make_fleet as make_fleet_j

    fj = make_fleet_j(jax.random.PRNGKey(2), n_cells=2, n_devices=4)
    specs, specs_j = cell_specs(to_port(fj)), cell_specs_j(fj)
    assert specs.gain == tuple(specs_j.gain) == ("cells", None)
    # the port's per-cell scalars are (C, 1), the reference's (C,)
    assert specs.bandwidth_total == ("cells", None)
    assert tuple(specs_j.bandwidth_total) == ("cells",)
    assert specs.resolutions == fj.resolutions


def test_pad_cells_replicates_last_cell():
    f = fleet(3, N=4)
    padded = pad_cells(f, 5)
    assert padded.gain.shape == (5, 4)
    assert padded.bandwidth_total.shape == (5, 1)
    assert torch.equal(padded.gain[3], f.gain[2])
    assert torch.equal(padded.gain[4], f.gain[2])
    assert pad_cells(f, 3) is not None and pad_cells(f, 3).gain is f.gain


def test_region_mesh_devices():
    mesh = cpu_mesh(3)
    assert isinstance(mesh, RegionMesh) and mesh.size == 3
    assert mesh.axis_name == "cells"
    assert region_mesh(2, devices=["cpu"] * 3).size == 2
    with pytest.raises(ValueError):
        region_mesh(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices"):
            region_mesh()
    with pytest.raises(ValueError, match="requires Problem.mesh"):
        rt.solve(rt.Problem(system=fleet(2), weights=W),
                 SPEC.replace(lockstep=True))


def test_mesh_solve_matches_repro_one_device_mesh():
    """`repro`'s region solve on its one-device mesh and the port's on a
    CPU mesh agree: objectives and allocations to 1e-9, the same
    iterations, the region stats (SP2 evals within Queue 3's slack)."""
    fj = repro.make_fleet(jax.random.PRNGKey(2), n_cells=5, n_devices=16)
    spec_kw = dict(max_iters=6, tol=1e-5)
    rj = repro.solve(repro.Problem(system=fj, weights=repro.Weights(0.5, 0.5,
                                                                    1.0),
                                   mesh=repro.region_mesh()),
                     repro.SolverSpec(**spec_kw))
    rr = rt.solve(rt.Problem(system=to_port(fj), weights=W,
                             mesh=cpu_mesh(1)), rt.SolverSpec(**spec_kw))
    np.testing.assert_array_equal(rr.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_allclose(rr.objective.numpy(), np.asarray(rj.objective),
                               rtol=1e-9)
    for f in FIELDS[:4]:
        a = getattr(rr.allocation, f).numpy()
        b = np.asarray(getattr(rj.allocation, f))
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), f
    sj, st = rj.stats, rr.stats
    for k in ("cells", "mesh_devices", "converged_frac", "iters_max",
              "iters_mean", "bcd_iters_total", "sp1_evals_total"):
        assert st[k] == sj[k], k
    assert st["objective_mean"] == pytest.approx(sj["objective_mean"],
                                                 rel=1e-9)
    assert abs(st["sp2_evals_total"] - sj["sp2_evals_total"]) \
        <= EV_SLACK_PER_ITER * sj["bcd_iters_total"]
