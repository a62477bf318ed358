"""The port's SLO plane, scrape endpoint and profiling (`repro_torch.obs`:
`slo`, `http`, `profile`) against `repro.obs`, on the CPU.

Mirrors tests/test_slo.py: burn rates and verdicts equal to `repro`'s on
the same count sequences (logical clocks), the latency-threshold bucket
snap, the HTTP scrape round trip, SLO verdicts over a live serve of the
port's pipeline, the `SloObserver` logical clock, a torch.profiler trace
session, and `record_cost` / `solve_cost` keys, gauges and guardrails
(not FLOP values: the port counts with `FlopCounterMode`, the reference
reads XLA's cost model). Not mirrored: the reference's
`benchmarks/compare.py` SLO gate, which belongs to the JAX package's
benchmark.
"""
import json
import math
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

from repro import obs as obs_j

import repro_torch as rt
from repro_torch import obs
from repro_torch.obs import (DEFAULT_WINDOWS, LatencyObjective,
                             MetricsServer, RatioObjective, SLO, SloObserver,
                             SloPlane, default_slos, parse_prometheus_text,
                             prometheus_text, profile)
from repro_torch.region import RegionAllocator

from _torch_serve import requests

W = rt.Weights(0.5, 0.5, 1.0)
SPEC = rt.SolverSpec(max_iters=4, tol=1e-4)


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


# ---------------------------------------------------------------------------
# burn-rate window math: the same verdicts as repro on the same counts
# ---------------------------------------------------------------------------

def _ratio_plane(o, objective=0.9):
    reg = o.MetricsRegistry()
    windows = (o.BurnWindow("fast", 10.0, 1.0), o.BurnWindow("slow", 100.0,
                                                            0.5))
    slo = o.SLO("hit_rate", objective, o.RatioObjective("good", "total"),
                windows)
    return reg, o.SloPlane([slo], registry=reg)


def _exact_and_multi_window(o):
    reg, plane = _ratio_plane(o, objective=0.5)
    plane.observe(now=0.0)
    reg.counter("total").inc(100)
    reg.counter("good").inc(75)
    out = [plane.check(now=10.0)]
    reg.counter("total").inc(100)
    out.append(plane.check(now=12.0))
    return out, reg


def _windows_difference_samples(o):
    reg, plane = _ratio_plane(o)
    plane.observe(now=0.0)
    reg.counter("total").inc(100)
    plane.observe(now=50.0)
    reg.counter("total").inc(100)
    reg.counter("good").inc(100)
    return [plane.check(now=61.0)], reg


def _no_data_and_idle(o):
    reg, plane = _ratio_plane(o)
    out = [plane.check(now=0.0)]
    reg.counter("total").inc(10)
    reg.counter("good").inc(10)
    out += [plane.check(now=1.0), plane.check(now=500.0)]
    return out, reg


def _latency_over_default_slos(o):
    reg = o.MetricsRegistry()
    plane = o.SloPlane(o.default_slos(latency_threshold_s=0.05), registry=reg)
    h = reg.histogram("region_request_latency_seconds")
    out = []
    for t, lats in enumerate(([0.01] * 50, [0.2] * 3 + [0.01] * 7, [0.5])):
        h.observe_many(lats)
        reg.counter("region_solve_cells").inc(len(lats))
        reg.counter("region_solve_converged_cells").inc(len(lats) - 1)
        out.append(plane.check(now=30.0 * t))
    return out, reg


@pytest.mark.parametrize("script", [_exact_and_multi_window,
                                    _windows_difference_samples,
                                    _no_data_and_idle,
                                    _latency_over_default_slos])
def test_burn_rates_and_verdicts_equal_repro(script):
    out_t, reg_t = script(obs)
    out_j, reg_j = script(obs_j)
    assert out_t == out_j
    assert prometheus_text(reg_t) == obs_j.prometheus_text(reg_j)


def test_burn_rate_exact_values():
    [[v], [v2]], reg = _exact_and_multi_window(obs)
    by = {w["name"]: w for w in v["windows"]}
    assert by["fast"]["burn_rate"] == pytest.approx(0.5)
    assert not by["slow"]["breach"] and v["verdict"] == "ok"
    assert v["good_ratio"] == pytest.approx(0.75)
    by = {w["name"]: w for w in v2["windows"]}
    assert by["fast"]["burn_rate"] == pytest.approx(1.25)
    assert v2["verdict"] == "breach"
    assert reg.gauge("slo_breaching", slo="hit_rate").value == 1.0
    [[v]], _ = _windows_difference_samples(obs)
    assert v["verdict"] == "warn"
    [[a], [b], [c]], _ = _no_data_and_idle(obs)
    assert a["verdict"] == "no_data" and a["good_ratio"] is None
    assert b["verdict"] == c["verdict"] == "ok"


def test_slo_validation_and_default_slos():
    with pytest.raises(ValueError):
        SLO("bad", 1.0, RatioObjective("g", "t"))
    with pytest.raises(ValueError):
        SloPlane([SLO("dup", 0.9, RatioObjective("g", "t")),
                  SLO("dup", 0.9, RatioObjective("g2", "t2"))])
    slos = default_slos()
    assert [s.name for s in slos] == ["serve_latency_p99",
                                      "deadline_hit_rate", "bcd_convergence"]
    assert all(s.windows == DEFAULT_WINDOWS for s in slos)
    assert [s.describe() for s in (x.source for x in slos)] \
        == [s.describe() for s in (x.source for x in obs_j.default_slos())]


def test_latency_objective_threshold_snaps_up():
    reg = obs.MetricsRegistry()
    h = reg.histogram("lat")
    edge = h.bounds[int(np.searchsorted(h.bounds, 0.5))]
    assert edge >= 0.5 and edge / 0.5 < 1.08
    h.observe_many([edge * 0.999, edge * 1.001, 0.001])
    assert LatencyObjective("lat", 0.5).counts(reg) == (2.0, 3.0)
    assert LatencyObjective("lat", h.bounds[-1] * 10).counts(reg) \
        == (3.0, 3.0)


# ---------------------------------------------------------------------------
# wire surface
# ---------------------------------------------------------------------------

def test_http_scrape_roundtrip():
    reg = obs.MetricsRegistry()
    reg.counter("req", stage="plan").inc(3)
    reg.gauge("depth").set(2)
    reg.histogram("lat").observe_many([0.001, 0.004, 2.0])
    with MetricsServer(registry=reg) as srv:
        assert srv.host == "127.0.0.1" and srv.port > 0
        status, ctype, body = _get(srv.url("/metrics"))
        assert status == 200 and ctype.startswith("text/plain")
        parsed = parse_prometheus_text(body.decode())
        assert parsed[("obs_scrapes_total", (("path", "/metrics"),))] == 1.0
        assert parsed == parse_prometheus_text(prometheus_text(reg))
        assert parsed[("req_total", (("stage", "plan"),))] == 3.0
        status, _, body = _get(srv.url("/healthz"))
        assert status == 200 and json.loads(body)["status"] == "ok"
        status, _, body = _get(srv.url("/slo"))
        assert status == 200 and json.loads(body) == {"slos": []}
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(srv.url("/nope"))
        assert err.value.code == 404
    assert not srv.running
    assert parse_prometheus_text("# HELP x\n\n") == {}
    with pytest.raises(ValueError):
        parse_prometheus_text("!!! not a sample line\n")


def test_live_serve_slo_verdicts_and_scrape():
    """The port's pipeline feeds the global registry; the default SLOs
    return verdicts over it, and the scrape parses."""
    plane = SloPlane(default_slos())
    plane.observe()
    base = obs.counter("region_deadline_requests").value
    cells_base = obs.counter("region_solve_cells").value
    with MetricsServer(slo_plane=plane) as srv:
        svc = RegionAllocator(W, cells_per_batch=2, min_bucket=8, spec=SPEC,
                              device="cpu")
        now = time.monotonic()
        for i, n in enumerate((5, 7, 8)):
            svc.submit(requests(i, n, seed=30 + i, deadline=now + 60.0)[1])
        svc.submit(requests(9, 6, seed=39, deadline=now - 1.0)[1])
        responses = svc.flush()
        assert len(responses) == 4
        _, _, body = _get(srv.url("/metrics"))
        parsed = parse_prometheus_text(body.decode())
        assert parsed[("region_deadline_requests_total", ())] == base + 4
        assert parsed[("region_solve_cells_total", ())] == cells_base + 4
        _, _, body = _get(srv.url("/slo"))
        slos = {s["name"]: s for s in json.loads(body)["slos"]}
        assert set(slos) == {"serve_latency_p99", "deadline_hit_rate",
                             "bcd_convergence"}
        assert slos["deadline_hit_rate"]["verdict"] != "no_data"
        for s in slos.values():
            assert all(math.isfinite(w["burn_rate"]) for w in s["windows"])
    st = svc.stats
    assert st["cells_solved"] == 4 and st["deadline_requests"] == 4
    assert st["deadline_hits"] == 3
    assert st["solver_counters"]["bcd_iters"] > 0
    assert st["solver_counters"]["sp2_evals"] > 0


def test_slo_observer_logical_clock_and_server():
    reg = obs.MetricsRegistry()
    plane = SloPlane(default_slos(), registry=reg)
    ticks = [0.0]

    def clock():
        ticks[0] += 1.0
        return ticks[0]

    d = SloObserver(plane, period_s=0.01, clock=clock)
    assert not d.running
    d.start()
    deadline = time.monotonic() + 5.0
    while d.ticks < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    t0 = time.monotonic()
    d.stop(timeout=5.0)
    assert time.monotonic() - t0 < 1.0 and not d.running
    ring = plane._rings[plane.slos[0].name]
    assert len(ring) == d.ticks >= 3
    assert ring[0][0] == 1.0 and ring[1][0] == 2.0
    d.stop()
    with pytest.raises(ValueError):
        SloObserver(plane, period_s=0.0)
    with MetricsServer(registry=reg, slo_plane=plane,
                       observe_period_s=0.01) as srv:
        assert srv.observer is not None and srv.observer.running
        status, _, body = _get(srv.url("/slo"))
        assert status == 200 and "slos" in json.loads(body)
    assert srv.observer is None
    with MetricsServer(registry=reg, observe_period_s=0.01) as srv2:
        assert srv2.observer is None


# ---------------------------------------------------------------------------
# profiling plane
# ---------------------------------------------------------------------------

def test_profile_trace_session(tmp_path):
    reg = obs.MetricsRegistry()
    logdir = str(tmp_path / "trace")
    rec = obs.MemoryRecorder()
    with obs.recording(rec):
        with profile.trace(logdir, label="unit", registry=reg) as d:
            assert d == logdir
            with profile.trace(logdir, registry=reg) as nested:
                assert nested is None     # one session at a time
            with obs.span("inside"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    assert reg.gauge("profiler_trace_seconds", label="unit").value > 0.0
    assert reg.counter("profiler_traces").value == 1.0
    assert any(e["name"] == "profile" for e in rec.events)
    assert os.listdir(logdir) == ["unit.trace.json"]
    trace = json.load(open(os.path.join(logdir, "unit.trace.json")))
    assert any(e.get("name") == "inside" for e in trace["traceEvents"])


def test_record_cost_gauges():
    reg = obs.MetricsRegistry()
    x = torch.ones(64, 64, dtype=torch.float64)
    cost = profile.record_cost("dot.64", torch.matmul, x, x, registry=reg)
    assert set(cost) == {"flops", "bytes_accessed"}
    assert cost["flops"] == 2 * 64 ** 3 and cost["bytes_accessed"] == 0.0
    assert reg.gauge("xla_cost_flops", shape="dot.64").value == cost["flops"]
    assert reg.gauge("xla_cost_bytes", shape="dot.64").value == 0.0


def test_solve_cost_labels_and_guardrails():
    reg = obs.MetricsRegistry()
    sysp = rt.make_system(0, 6, device="cpu", dtype=torch.float64)
    cost = profile.solve_cost(rt.Problem(system=sysp, weights=W), SPEC,
                              registry=reg)
    assert set(cost) == {"flops", "bytes_accessed"} and cost["flops"] >= 0
    fleet = rt.make_fleet(1, 3, 6, device="cpu", dtype=torch.float64)
    profile.solve_cost(rt.Problem(system=fleet, weights=W), SPEC,
                       registry=reg)
    shapes = {dict(g.labels)["shape"] for g in reg.gauges()}
    assert shapes == {"solve.bcd.N6", "solve.fleet.C3.N6"}
    for extra in (dict(rounds=rt.RoundsConfig(rounds=2), key=2),
                  dict(deadline=100.0),
                  dict(mesh=rt.region_mesh(devices=["cpu"]))):
        with pytest.raises(ValueError, match="solve_cost"):
            profile.solve_cost(rt.Problem(system=fleet, weights=W, **extra),
                               SPEC)
