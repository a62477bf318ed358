"""The port's region serving stack (`repro_torch.region`: admission ->
planning -> dispatch -> completion, `RegionAllocator`, and
`dynamics.replay_mobility`) against `repro.region` on the CPU.

Mirrors tests/test_region_pipeline.py, tests/test_region_service.py and
tests/test_mobility.py::test_replay_*: the same request traces go through
`repro.region.RegionAllocator` / `RegionPipeline` and the port's, compared
on responses (float64: objectives and allocations to 1e-9 relative, equal
iterations, convergence, warm flags and buckets), serving tallies (SP2
evals within ROADMAP Queue 3's slack), batch policies, priority order,
warm-start coherence, LRU eviction and handover purges; the port's own
depth invisibility, futures and stage clocks bit for bit. Every
comparison with `repro` shares one spec and batch widths 1 and 2, so the
reference compiles few shapes. Not mirrored: the reference's deprecated
`StageClocks` aggregate properties (`clocks.plan_s += dt`) and its legacy
`RegionAllocator` solver keywords / `solver_kw` / `_cache` views, which
the port leaves out.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

import repro
from repro.dynamics import MobilityConfig as MobilityConfig_j
from repro.region import RegionAllocator as RegionAllocator_j
from repro.region import RegionPipeline as RegionPipeline_j

import repro_torch as rt
from repro_torch import interop
from repro_torch.core.bcd import initial_allocation, stack_systems
from repro_torch.dynamics import (MobilityConfig, replay_mobility,
                                  simulate_mobility)
from repro_torch.region import (CloseOnFull, DeadlineSlack, MaxWait,
                                RegionAllocator, RegionPipeline,
                                WarmStartCache, bucket_size,
                                inactive_system, pad_system)
from repro_torch.region.planning import _full_allocation

from _torch_serve import requests, same_response, same_stats, to_port
from test_torch_mobility import reference_draws

W = (0.5, 0.5, 1.0)
SPEC = dict(max_iters=8, tol=1e-5)


def pipelines(**kw):
    """(reference pipeline, port pipeline) with the same settings."""
    kw.setdefault("cells_per_batch", 2)
    kw.setdefault("min_bucket", 8)
    policy = kw.pop("policy", None)
    pj = RegionPipeline_j(repro.Weights(*W), spec=repro.SolverSpec(**SPEC),
                          policy=policy and policy[0], **kw)
    pt = RegionPipeline(rt.Weights(*W), spec=rt.SolverSpec(**SPEC),
                        policy=policy and policy[1], device="cpu", **kw)
    return pj, pt


def allocators(**kw):
    kw.setdefault("cells_per_batch", 2)
    kw.setdefault("min_bucket", 8)
    sj = RegionAllocator_j(repro.Weights(*W), spec=repro.SolverSpec(**SPEC),
                           **kw)
    st = RegionAllocator(rt.Weights(*W), spec=rt.SolverSpec(**SPEC),
                         device="cpu", **kw)
    return sj, st


def solve_both(sj, st, reqs):
    oj = sj.solve([r[0] for r in reqs])
    ot = st.solve([r[1] for r in reqs])
    assert list(ot) == list(oj)
    for cid in oj:
        same_response(oj[cid], ot[cid])
    return oj, ot


def bit_equal(a, b):
    if (a.cell_id, a.objective, a.iters, a.converged, a.warm,
            a.bucket) != (b.cell_id, b.objective, b.iters, b.converged,
                          b.warm, b.bucket):
        return False
    return all(torch.equal(getattr(a.allocation, f), getattr(b.allocation, f))
               for f in ("bandwidth", "power", "freq", "resolution",
                         "s_relaxed", "T"))


# ---------------------------------------------------------------------------
# the facade against repro; depth is invisible in the port
# ---------------------------------------------------------------------------

def test_pipeline_depth_is_bit_invisible():
    """The same trace through the port at depth 1 and depth 3 gives
    bit-identical responses and tallies, and both agree with `repro`."""
    sizes = [5, 9, 6, 14, 7, 12, 11, 6, 30]
    sj = RegionAllocator_j(repro.Weights(*W), cells_per_batch=2,
                           min_bucket=8, spec=repro.SolverSpec(**SPEC))
    traces = []
    for depth in (1, 3):
        st = RegionAllocator(rt.Weights(*W), cells_per_batch=2, min_bucket=8,
                             spec=rt.SolverSpec(**SPEC), pipeline_depth=depth,
                             device="cpu")
        outs = []
        for drift in (0.0, 0.01):
            reqs = [requests(i, n, drift=drift) for i, n in enumerate(sizes)]
            if depth == 1:
                outs.append(solve_both(sj, st, reqs)[1])
            else:
                outs.append(st.solve([r[1] for r in reqs]))
        traces.append((outs, dict(st.stats)))
    (a, sa), (b, sb) = traces
    same_stats(sj.stats, sa)
    assert sa == sb
    for out_a, out_b in zip(a, b):
        assert list(out_a) == list(out_b)
        assert all(bit_equal(out_a[c], out_b[c]) for c in out_a)
    assert all(r.warm for r in a[1].values())


def test_mixed_size_trace_bucketing_and_warm_cache():
    """Pools of 5..60 devices take <= 4 batch shapes; drifted re-requests
    hit the warm cache in <= 3 BCD iterations; responses come back at the
    request's own size."""
    sj, st = allocators()
    sizes = [5, 7, 9, 14, 17, 25, 33, 50, 60, 12, 28, 6]
    oj, ot = solve_both(sj, st, [requests(i, n)
                                 for i, n in enumerate(sizes)])
    assert len(st.compiled_shapes) <= 4
    assert all(r.converged and np.isfinite(r.objective) and not r.warm
               for r in ot.values())
    for i, n in enumerate(sizes):
        assert ot[i].allocation.bandwidth.shape == (n,)
        assert ot[i].bucket == bucket_size(n, 8)
    shapes = set(st.compiled_shapes)
    oj, ot = solve_both(sj, st, [requests(i, n, drift=0.02)
                                 for i, n in enumerate(sizes)])
    assert all(r.warm for r in ot.values())
    assert max(r.iters for r in ot.values()) <= 3
    assert st.compiled_shapes == shapes
    same_stats(sj.stats, st.stats)


def test_service_matches_direct_solve():
    """A served cell equals the port's direct unpadded solve of it."""
    _, st = allocators()
    rj, rq = requests(0, 11)
    res = st.solve([rq])[0]
    direct = rt.solve(rt.Problem(system=rq.sys, weights=rt.Weights(*W)),
                      rt.SolverSpec(**SPEC))
    assert res.iters == direct.iters
    assert res.objective == pytest.approx(direct.objective, rel=1e-9)
    np.testing.assert_allclose(res.allocation.bandwidth.numpy(),
                               direct.allocation.bandwidth.numpy(),
                               rtol=1e-9)


def test_submit_flush_stream_and_chunking():
    _, st = allocators(cells_per_batch=2)
    for i in range(5):
        st.submit(requests(i, 6)[1])
    res = st.flush()
    assert set(res) == set(range(5))
    assert st.flush() == {}
    assert st.stats["requests"] == 5
    assert st.stats["batches"] == 3            # ceil(5 / 2)
    assert len(st.compiled_shapes) == 1        # all (2, 8)
    assert st.stats["cells_padded"] == 1       # the last chunk padded 1


def test_pool_resize_and_lru_eviction():
    sj, st = allocators(cache_size=2)
    solve_both(sj, st, [requests(i, 6) for i in range(3)])
    assert len(st.pipeline.cache) == 2
    # cell 0 was evicted (first in), cells 1-2 stay warm
    oj, ot = solve_both(sj, st, [requests(i, 6, drift=0.01)
                                 for i in range(3)])
    assert not ot[0].warm and ot[1].warm and ot[2].warm
    # a resized pool never warm-starts from the stale solution
    oj, ot = solve_both(sj, st, [requests(1, 9)])
    assert not ot[1].warm and ot[1].allocation.bandwidth.shape == (9,)
    assert st.pipeline.cache.resize_purges == 1
    same_stats(sj.stats, st.stats)


def test_inactive_pad_lanes_keep_real_lanes_bit_identical():
    """A short chunk padded with all-inactive filler cells solves its real
    lanes bit-identically to padding with a copy of cell 0, and the filler
    lane converges after one masked iteration."""
    C, bucket = 4, 8
    sysps = [requests(i, 6)[1].sys for i in range(3)]
    padded = [pad_system(s, bucket) for s in sysps]
    inits = [_full_allocation(initial_allocation(p)) for p in padded]

    def batch(filler_sys, filler_init):
        sys_b = stack_systems(padded + [filler_sys])
        init_b = rt.Allocation(**{
            k: torch.stack([getattr(a, k) for a in inits + [filler_init]])
            for k in ("bandwidth", "power", "freq", "resolution",
                      "s_relaxed", "T")})
        return rt.solve(rt.Problem(system=sys_b, weights=[rt.Weights(*W)] * C,
                                   init=init_b), rt.SolverSpec(**SPEC))

    filler = inactive_system(padded[0])
    new = batch(filler, _full_allocation(initial_allocation(filler)))
    old = batch(padded[0], inits[0])
    for f in ("bandwidth", "power", "freq", "resolution", "s_relaxed", "T"):
        assert torch.equal(getattr(new.allocation, f)[:3],
                           getattr(old.allocation, f)[:3])
    assert torch.equal(new.objective[:3], old.objective[:3])
    assert torch.equal(new.iters[:3], old.iters[:3])
    assert int(new.iters[3]) == 1 and bool(new.converged[3])


# ---------------------------------------------------------------------------
# futures (the port's own)
# ---------------------------------------------------------------------------

def test_out_of_order_result_materializes_only_its_batch():
    _, pipe = pipelines(max_in_flight=4)
    futs = [pipe.submit(requests(i, 6)[1]) for i in range(4)]
    batches = pipe.pump(force=True)
    assert len(batches) == 2 and pipe.in_flight == 2
    assert all(f.dispatched and not f.done() for f in futs)
    assert all(b.event is None for b in batches)     # a CPU pipeline
    late = futs[3].result()
    assert futs[3].done() and futs[2].done()
    assert not futs[0].done() and not futs[1].done()
    assert batches[1].materialized and not batches[0].materialized
    assert pipe.in_flight == 1 and late.cell_id == 3
    early = futs[0].result()
    assert early.cell_id == 0 and pipe.in_flight == 0
    assert all(f.done() for f in futs)


def test_result_on_queued_request_forces_dispatch():
    _, pipe = pipelines()
    fut = pipe.submit(requests("solo", 6)[1])
    assert not fut.dispatched and pipe.pending == 1
    res = fut.result()
    assert res.cell_id == "solo" and fut.done()
    assert pipe.pending == 0 and pipe.in_flight == 0


def test_depth_bound_evicts_oldest():
    _, pipe = pipelines(max_in_flight=1)
    futs = [pipe.submit(requests(i, 6)[1]) for i in range(4)]
    pipe.pump(force=True)
    assert pipe.in_flight == 1
    assert futs[0].done() and futs[1].done() and not futs[3].done()


def test_pipeline_solves_on_the_named_device():
    _, pipe = pipelines()
    assert pipe.device == torch.device("cpu")
    pipe.submit(requests(0, 6)[1])
    (batch,) = pipe.pump(force=True)
    assert batch.plan.sys_batch.device.type == "cpu"
    out = pipe.drain()
    assert out[0].allocation.bandwidth.device.type == "cpu"


# ---------------------------------------------------------------------------
# admission policies under a logical clock, priority order: both packages
# ---------------------------------------------------------------------------

def both_poll(pj, pt, now):
    bj, bt = pj.poll(now=now), pt.poll(now=now)
    assert [b.plan.n_real for b in bt] == [b.plan.n_real for b in bj]
    assert [[r.cell_id for r in b.plan.requests] for b in bt] \
        == [[r.cell_id for r in b.plan.requests] for b in bj]
    return bt


def drain_both(pj, pt, now=None):
    oj, ot = pj.drain(now=now), pt.drain(now=now)
    assert len(ot) == len(oj)
    for a, b in zip(oj, ot):
        same_response(a, b)
    return ot


def test_close_on_full_waits_for_full_batches():
    pj, pt = pipelines(policy=(repro.region.CloseOnFull(), CloseOnFull()))
    for p, r in zip((pj, pt), requests(0, 6)):
        p.submit(r, now=0.0)
    assert both_poll(pj, pt, 1e9) == []
    for p, r in zip((pj, pt), requests(1, 6)):
        p.submit(r, now=2.0)
    (batch,) = both_poll(pj, pt, 3.0)
    assert batch.plan.n_real == 2 and pt.pending == 0
    drain_both(pj, pt)


def test_max_wait_closes_partial_batches():
    pj, pt = pipelines(policy=(repro.region.MaxWait(10.0), MaxWait(10.0)))
    for p, r in zip((pj, pt), requests(0, 6)):
        p.submit(r, now=0.0)
    assert both_poll(pj, pt, 9.0) == []
    (batch,) = both_poll(pj, pt, 10.0)
    assert batch.plan.n_real == 1
    assert pt.clocks.total("queue_wait") == pytest.approx(10.0)
    drain_both(pj, pt)
    with pytest.raises(ValueError):
        MaxWait(-1.0)


def test_deadline_slack_closes_for_tight_requests():
    pj, pt = pipelines(policy=(repro.region.DeadlineSlack(slack=5.0),
                               DeadlineSlack(slack=5.0)))
    for p, r in zip((pj, pt), requests(1, 6, deadline=20.0)):
        p.submit(r, now=0.0)
    assert both_poll(pj, pt, 10.0) == []                  # 10 > slack
    (batch,) = both_poll(pj, pt, 15.0)                    # 5 <= slack
    assert batch.plan.n_real == 1
    drain_both(pj, pt)
    # a request without a deadline rides along with a tight one
    pipe = RegionPipeline(rt.Weights(*W), cells_per_batch=3, min_bucket=8,
                          spec=rt.SolverSpec(**SPEC), device="cpu",
                          policy=DeadlineSlack(slack=5.0))
    pipe.submit(requests(0, 6)[1], now=0.0)
    pipe.submit(requests(1, 6, deadline=20.0)[1], now=0.0)
    assert pipe.poll(now=10.0) == []
    (batch,) = pipe.poll(now=15.0)
    assert batch.plan.n_real == 2


def test_priority_orders_within_and_across_batches():
    pj, pt = pipelines()
    for cid, prio in (("lo", 0), ("hi", 5), ("mid", 1)):
        for p, r in zip((pj, pt), requests(cid, 6, priority=prio)):
            p.submit(r, now=0.0)
    bt = pt.pump(now=0.0, force=True)
    bj = pj.pump(now=0.0, force=True)
    order = [[r.cell_id for r in b.plan.requests] for b in bt]
    assert order == [[r.cell_id for r in b.plan.requests] for b in bj]
    assert order == [["hi", "mid"], ["lo"]]
    drain_both(pj, pt)


# ---------------------------------------------------------------------------
# warm-start coherence, duplicates, interleaved buckets, LRU
# ---------------------------------------------------------------------------

def test_in_flight_cell_stalls_replan_until_cache_written():
    pj, pt = pipelines(cells_per_batch=1, max_in_flight=2)
    for p, r in zip((pj, pt), requests("x", 6, seed=1)):
        p.submit(r)
    (first,) = pt.pump(force=True)
    pj.pump(force=True)
    assert pt.in_flight == 1 and not first.materialized
    for p, r in zip((pj, pt), requests("x", 6, seed=1, drift=0.01)):
        p.submit(r)
    (second,) = pt.pump(force=True)
    pj.pump(force=True)
    assert first.materialized
    assert second.plan.warm == [True]
    out = drain_both(pj, pt)
    assert [r.warm for r in out] == [False, True]
    assert out[1].iters <= 3


def test_duplicate_cell_id_in_one_solve_keeps_last_response():
    sj, st = allocators(cells_per_batch=1)
    oj, ot = solve_both(sj, st, [requests("dup", 6, seed=3),
                                 requests("dup", 6, seed=3, drift=0.02)])
    assert set(ot) == {"dup"} and ot["dup"].warm
    assert st.stats["requests"] == 2 and st.stats["batches"] == 2


def test_warm_cache_resize_purge_frees_capacity():
    cache = WarmStartCache(2)
    alloc = initial_allocation(requests(0, 4)[1].sys)
    cache.store("a", 4, alloc)
    cache.store("b", 4, alloc)
    assert cache.lookup("b", 4) is alloc and cache.hits == 1
    assert cache.lookup("a", 8) is None
    assert cache.resize_purges == 1 and cache.misses == 1
    assert "a" not in cache and len(cache) == 1
    cache.store("c", 4, alloc)
    assert cache.evictions == 0 and "b" in cache
    cache.store("d", 4, alloc)
    assert cache.evictions == 1 and "b" not in cache
    with pytest.raises(ValueError):
        WarmStartCache(0)


def test_interleaved_buckets_warm_hit_accounting():
    sj, st = allocators()
    sizes = {0: 6, 1: 12, 2: 7, 3: 14}
    solve_both(sj, st, [requests(i, n) for i, n in sizes.items()])
    oj, ot = solve_both(sj, st, [requests(i, n, drift=0.01)
                                 for i, n in sizes.items()])
    assert all(r.warm for r in ot.values())
    assert st.stats["cache_hits"] == 4 and st.stats["cache_misses"] == 4
    assert st.pipeline.cache.hits == 4 and st.pipeline.cache.misses == 4
    assert st.compiled_shapes == {(2, 8), (2, 16)}
    same_stats(sj.stats, st.stats)


def test_stage_clocks_cover_all_four_layers():
    _, pipe = pipelines()
    for i in range(4):
        pipe.submit(requests(i, 6)[1], now=float(i))
    out = pipe.drain(now=10.0)
    assert len(out) == 4
    clocks = pipe.clocks.as_dict()
    assert set(clocks) == {"queue_wait_s", "plan_s", "dispatch_s",
                           "device_s", "gather_s"}
    assert clocks["queue_wait_s"] == pytest.approx(34.0)
    for key in ("plan_s", "dispatch_s", "device_s", "gather_s"):
        assert clocks[key] > 0.0, key
    assert not hasattr(pipe.clocks, "plan_s")     # no aggregate shims


# ---------------------------------------------------------------------------
# handover invalidation and mobility replay
# ---------------------------------------------------------------------------

def test_handover_invalidate_purges_and_counts():
    sj, st = allocators()
    solve_both(sj, st, [requests("a", 6, seed=1), requests("b", 6, seed=2)])
    for s in (sj, st):
        assert s.invalidate("a") is True
        assert s.invalidate("a") is False
        assert s.invalidate("nope") is False
    assert st.stats["handover_purges"] == 1
    assert st.pipeline.cache.handover_purges == 1
    oj, ot = solve_both(sj, st, [requests("a", 6, seed=1, drift=0.01),
                                 requests("b", 6, seed=2, drift=0.01)])
    assert not ot["a"].warm and ot["b"].warm
    same_stats(sj.stats, st.stats)


def test_handover_invalidate_materializes_in_flight_batch():
    _, pipe = pipelines(cells_per_batch=1, max_in_flight=2)
    pipe.submit(requests("x", 6, seed=9)[1])
    pipe.pump(force=True)
    assert pipe._in_flight
    assert pipe.invalidate("x") is True
    assert not pipe._in_flight
    assert pipe.stats["handover_purges"] == 1
    out = pipe.drain()
    assert len(out) == 1 and out[0].cell_id == "x" and out[0].converged
    pipe.submit(requests("x", 6, seed=9, drift=0.01)[1])
    assert not pipe.drain()[0].warm


def replay_both(cfg_kw, key, n, n_cells, base_seed):
    """repro's and the port's `replay_mobility` over the same trace (the
    port's built from the reference's draws)."""
    cfg_j, cfg = MobilityConfig_j(**cfg_kw), MobilityConfig(**cfg_kw)
    tj = repro.simulate_mobility(key, n_devices=n, n_cells=n_cells,
                                 cfg=cfg_j, dtype="float64")
    draws = interop.mobility_draws_from_numpy(
        reference_draws(key, n, n_cells, cfg_j, jnp.float64), device="cpu")
    tt = simulate_mobility(draws, n, n_cells, cfg, dtype=torch.float64,
                           device="cpu")
    assert np.array_equal(tt.serving.numpy(), np.asarray(tj.serving))
    base_j = repro.make_system(jax.random.PRNGKey(base_seed), n_devices=n)
    sj, st = allocators()
    rep_j = repro.replay_mobility(sj, tj, base_j)
    rep_t = replay_mobility(st, tt, to_port(base_j))
    for k in ("mean_warm_iters", "mean_cold_iters"):
        a, b = rep_t.pop(k), rep_j.pop(k)
        assert a == b or (np.isnan(a) and np.isnan(b)), k
    rep_j["compiled_shapes"] = [tuple(s) for s in rep_j["compiled_shapes"]]
    assert rep_t == rep_j
    same_stats(sj.stats, st.stats)
    return rep_t, st


def test_replay_handover_accounting():
    kw = dict(model="rwp", steps=5, dt=5.0, v_min=10.0, v_max=60.0,
              area_m=500.0)
    rep, svc = replay_both(kw, jax.random.PRNGKey(1), 20, 3, 2)
    assert rep["steps"] == 5 and rep["cells"] == 3
    assert rep["requests"] == 5 * 3
    assert rep["handover_purges"] == svc.stats["handover_purges"]
    assert rep["handover_purges"] <= 2 * rep["handovers"]
    assert rep["warm_solves"] + rep["cold_solves"] == rep["requests"]
    assert 0.0 <= rep["hit_rate"] <= 1.0


def test_replay_no_motion_no_purges():
    kw = dict(model="gauss_markov", steps=4, alpha=1.0, v_sigma=0.0,
              shadowing_db=0.0)
    rep, _ = replay_both(kw, jax.random.PRNGKey(4), 12, 2, 5)
    assert rep["handovers"] == 0 and rep["handover_purges"] == 0
    assert rep["cold_solves"] == 2
    assert rep["warm_solves"] == (4 - 1) * 2
