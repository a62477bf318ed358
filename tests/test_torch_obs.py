"""The port's telemetry layer (`repro_torch.obs`) against `repro.obs`, on
the CPU.

Mirrors tests/test_obs.py: recorder / span / point units, the metric
registry and its exporters (the same registry operations give
byte-identical Prometheus text and JSONL records in both packages), the
report CLI, the solver counters, `StageClocks`, and the same small serve
trace through `repro.region` and the port giving the same event stream
once timing is stripped (span names, nesting, attributes; the `request`
points' cell ids, buckets, warm flags and iterations; SP2 evals within
ROADMAP Queue 3's slack).

Two reference guards change form: the compile counter becomes "the
recorder changes no result bit, no `sp1_lambda_sum` call count and no
`while_cells` host-read count", and the 2%-of-wall-time overhead bound
becomes "the disabled path emits nothing and allocates no span" (a
wall-clock ratio on a shared CPU is not a steady test).
"""
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import repro
from repro import obs as obs_j
from repro.obs import report as report_j
from repro.region import RegionAllocator as RegionAllocator_j

import repro_torch as rt
from repro_torch import obs
from repro_torch.core.loops import while_cells
from repro_torch.kernels import ops as kops
from repro_torch.obs import recorder, report
from repro_torch.region import RegionAllocator, StageClocks

from _torch_rounds import EV_SLACK_PER_ITER
from _torch_serve import requests

W = (0.5, 0.5, 1.0)
SPEC = dict(max_iters=4, tol=1e-4)


@pytest.fixture(autouse=True)
def _clean_recorder():
    """Every test starts and ends on the default no-op recorders."""
    obs.set_recorder(None)
    obs_j.set_recorder(None)
    yield
    obs.set_recorder(None)
    obs_j.set_recorder(None)


# ---------------------------------------------------------------------------
# recorder / spans / points
# ---------------------------------------------------------------------------

def test_span_nesting_and_ids():
    rec = obs.MemoryRecorder()
    obs.set_recorder(rec)
    with obs.span("outer", tag="a"):
        with obs.span("inner"):
            obs.point("evt", k=3)
    obs.set_recorder(None)
    assert [e["name"] for e in rec.events] == ["evt", "inner", "outer"]
    evt, inner, outer = rec.events
    assert outer["parent"] == -1 and outer["span"] == 0
    assert inner["parent"] == outer["span"] and inner["span"] == 1
    assert evt["span"] == inner["span"] and evt["type"] == "point"
    assert outer["tag"] == "a" and evt["k"] == 3
    assert outer["dur_s"] >= inner["dur_s"] >= 0.0


def test_span_ids_reset_on_install():
    for _ in range(2):
        rec = obs.MemoryRecorder()
        obs.set_recorder(rec)
        with obs.span("s"):
            pass
        assert rec.events[0]["span"] == 0


def test_disabled_path_emits_nothing_and_allocates_no_span():
    """The reference bounds the disabled path's cost at 2% of serve wall
    time; here: one cached null span, and a serve trace under a disabled
    recorder never reaches its `emit`."""
    assert not obs.enabled()
    s1 = obs.span("anything", big_attr=list(range(100)))
    assert s1 is obs.span("else") is recorder._NULL_SPAN
    with s1:
        assert obs.point("evt", x=1) is None

    class Disabled(obs.Recorder):
        enabled = False

        def __init__(self):
            self.events = []

        def emit(self, event):
            self.events.append(event)

    rec = Disabled()
    obs.set_recorder(rec)
    serve(cells([5, 7]), "port")
    assert rec.events == []


def test_strip_timing():
    ev = dict(type="point", name="x", span=0, parent=0,
              ts=123.0, dur_s=0.5, latency_s=0.1, iters=3, stage="plan")
    assert obs.strip_timing(ev) == obs_j.strip_timing(ev) == dict(
        type="point", name="x", span=0, parent=0, iters=3, stage="plan")


def test_jsonl_recorder_roundtrip(tmp_path):
    path = str(tmp_path / "events.jsonl")
    with obs.recording(obs.JsonlRecorder(path)):
        with obs.span("run", n=np.int64(2), t=torch.tensor(4)):
            obs.point("evt", v=np.float64(1.5), u=torch.tensor(2.5))
    events = obs.read_jsonl(path)
    assert [e["name"] for e in events] == ["evt", "run"]
    assert events[0]["v"] == 1.5 and events[0]["u"] == 2.5
    assert events[1]["n"] == 2 and events[1]["t"] == 4


def test_recording_restores_previous():
    outer = obs.MemoryRecorder()
    obs.set_recorder(outer)
    with obs.recording(obs.MemoryRecorder()) as inner:
        obs.point("inner_evt")
    obs.point("outer_evt")
    obs.set_recorder(None)
    assert [e["name"] for e in inner.events] == ["inner_evt"]
    assert [e["name"] for e in outer.events] == ["outer_evt"]


def test_span_names_the_profiler_range():
    """An enabled span is a `record_function` range of its name in a
    torch.profiler trace; NVTX ranges exist on a CUDA build only."""
    from torch.profiler import ProfilerActivity, profile

    assert recorder._NVTX == (torch.version.cuda is not None)
    with obs.recording(obs.MemoryRecorder()):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.span("my_span"):
                torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert "my_span" in names


def test_jsonl_recorder_background_flush(tmp_path):
    path = str(tmp_path / "bg.jsonl")
    with obs.recording(obs.JsonlRecorder(path)):
        for i in range(500):
            obs.point("evt", i=i)
    assert [e["i"] for e in obs.read_jsonl(path)] == list(range(500))


def test_jsonl_recorder_drops_when_queue_full(tmp_path):
    path = str(tmp_path / "drop.jsonl")
    rec = obs.JsonlRecorder(path, queue_size=4)
    base = obs.counter("obs_events_dropped").value
    rec._drain_gate.clear()              # stall the writer
    rec.emit({"i": -1})
    deadline = time.perf_counter() + 5.0
    while rec._queue.qsize() and time.perf_counter() < deadline:
        time.sleep(0.001)
    for i in range(4):
        rec.emit({"i": i})
    rec.emit({"i": 99})                  # queue full -> dropped
    rec.emit({"i": 100})
    assert rec.dropped_events == 2
    assert obs.counter("obs_events_dropped").value == base + 2
    rec._drain_gate.set()
    rec.close()
    assert [e["i"] for e in obs.read_jsonl(path)] == [-1, 0, 1, 2, 3]
    rec.emit({"i": 101})
    assert rec.dropped_events == 3


# ---------------------------------------------------------------------------
# metrics + exporters: byte-identical with repro
# ---------------------------------------------------------------------------

def _ops_basic(o, reg):
    reg.counter("req", stage="plan").inc(3)
    reg.counter("req", stage="gather").inc(0.5)
    reg.gauge("depth").set(2)
    reg.gauge("depth").dec(0.25)
    reg.histogram("lat").observe_many([0.001, 0.002, 0.004, 5.0])


def _ops_lognormal(o, reg):
    vals = np.random.default_rng(0).lognormal(-4.0, 0.8, size=4000)
    reg.histogram("lat", route="a.b-c").observe_many(vals)
    reg.histogram("lat", route="x").observe_many(vals[:7])
    reg.counter("region.solve cells").inc(17)


def _ops_non_finite(o, reg):
    h = reg.histogram("lat")
    h.observe_many([1.0, float("nan"), float("inf"), 1e-6, 1e3])
    reg.gauge("nan_gauge").set(float("nan"))
    reg.gauge("inf_gauge").set(float("-inf"))
    reg.histogram("empty")


@pytest.mark.parametrize("ops", [_ops_basic, _ops_lognormal,
                                 _ops_non_finite])
def test_exports_byte_identical_with_repro(ops, tmp_path):
    out = {}
    for name, o in (("j", obs_j), ("t", obs)):
        reg = o.MetricsRegistry()
        ops(o, reg)
        path = str(tmp_path / f"{name}.jsonl")
        n = o.write_metrics_jsonl(path, reg)
        out[name] = (o.prometheus_text(reg), open(path).read(), n,
                     o.parse_prometheus_text(o.prometheus_text(reg)))
    assert out["t"][0] == out["j"][0]            # Prometheus text
    assert out["t"][1] == out["j"][1]            # JSONL, byte for byte
    assert out["t"][2] == out["j"][2]
    assert out["t"][3].keys() == out["j"][3].keys()
    assert obs.DEFAULT_BOUNDS == obs_j.DEFAULT_BOUNDS


def test_counter_gauge_and_histogram_units():
    reg = obs.MetricsRegistry()
    c = reg.counter("requests", stage="plan")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5 and reg.counter("requests", stage="plan") is c
    with pytest.raises(ValueError):
        c.inc(-1.0)
    vals = np.random.default_rng(0).lognormal(-4.0, 0.8, size=4000)
    h = obs.Histogram("lat")
    h.observe_many(vals)
    for q in (50, 90, 99):
        exact = np.percentile(vals, q)
        assert abs(h.percentile(q) - exact) / exact < 0.07
    assert h.percentile(0) == vals.min() and h.percentile(100) == vals.max()
    assert math.isnan(obs.Histogram("empty").percentile(50))
    h2 = obs.Histogram("lat")
    h2.observe_many([0.001, float("nan"), 0.002, float("inf")])
    assert h2.count == 2 and h2.dropped == 2


def test_report_matches_repro(tmp_path, capsys):
    path = str(tmp_path / "events.jsonl")
    with obs.recording(obs.JsonlRecorder(path)):
        with obs.span("solve"):
            obs.point("stage", stage="plan", dur_s=0.002)
            obs.point("stage", stage="gather", dur_s=0.001)
            obs.point("request", cell_id="c0", bucket=8, warm=False,
                      iters=3, converged=True, batch_seq=0,
                      bcd_iters=3.0, sp1_evals=147.0, sp2_evals=122.0,
                      residual=1e-7, latency_s=0.015, deadline_hit=True)
    assert report.main([path]) == 0
    out = capsys.readouterr().out
    for part in ("== spans ==", "== pipeline stages ==",
                 "== request latency ==", "== per-request solver counters ==",
                 "== deadlines == 1/1", "p50_ms", "sp2_evals"):
        assert part in out, part
    assert report_j.main([path]) == 0
    assert capsys.readouterr().out == out


# ---------------------------------------------------------------------------
# solver counters
# ---------------------------------------------------------------------------

def test_solve_counters_single_fleet_and_zero_iter():
    from repro_torch.core.accuracy import default_accuracy
    from repro_torch.core.sp1 import dual_evals_per_iter

    sysp = rt.make_system(1, 6, device="cpu", dtype=torch.float64)
    res = rt.solve(rt.Problem(system=sysp, weights=rt.Weights(*W)),
                   rt.SolverSpec(max_iters=8))
    d = res.counters.as_dict()
    assert set(d) == {"bcd_iters", "sp1_evals", "sp2_evals", "residual"}
    assert d["bcd_iters"] == res.iters
    assert d["sp2_evals"] == sum(r["sp2_iters"] for r in res.history)
    assert d["residual"] == pytest.approx(res.history[-1]["rel_step"])
    assert d["sp1_evals"] == res.iters * dual_evals_per_iter(
        "sweep", default_accuracy())
    fleet = rt.make_fleet(2, 3, 6, device="cpu", dtype=torch.float64)
    fr = rt.solve(rt.Problem(system=fleet, weights=rt.Weights(*W)),
                  rt.SolverSpec(max_iters=8))
    assert fr.counters.data.shape == (3, 4)
    assert torch.equal(fr.counters.col("bcd_iters"), fr.iters.double())
    zero = rt.solve(rt.Problem(system=sysp, weights=rt.Weights(*W)),
                    rt.SolverSpec(max_iters=0)).counters.as_dict()
    assert zero["bcd_iters"] == 0 and zero["sp2_evals"] == 0
    assert math.isnan(zero["residual"])


# ---------------------------------------------------------------------------
# StageClocks
# ---------------------------------------------------------------------------

def test_stage_clocks_samples_and_points():
    clocks = StageClocks()
    clocks.record("plan", 0.002)
    clocks.record("plan", 0.004)
    assert clocks.samples("plan") == [0.002, 0.004]
    assert clocks.count("plan") == 2
    assert clocks.total("plan") == pytest.approx(0.006)
    assert set(clocks.as_dict()) == {f"{s}_s" for s in StageClocks.STAGES}
    p = clocks.percentiles("plan")
    assert set(p) == {"p50", "p90", "p99"} and 0.002 <= p["p50"] <= 0.004
    assert math.isnan(clocks.percentiles("gather")["p50"])
    rec = obs.MemoryRecorder()
    obs.set_recorder(rec)
    clocks.record("dispatch", 0.001)
    obs.set_recorder(None)
    clocks.record("gather", 0.001)
    stages = [e for e in rec.events if e["name"] == "stage"]
    assert [(e["stage"], e["dur_s"]) for e in stages] == [("dispatch",
                                                          0.001)]


# ---------------------------------------------------------------------------
# the serve trace: the same event stream as repro's
# ---------------------------------------------------------------------------

def cells(sizes, seed=0):
    return [(f"cell{i}-{n}", n, seed * 100 + i) for i, n in enumerate(sizes)]


def serve(trace, which):
    """Serve `trace` through repro ("ref") or the port ("port")."""
    if which == "ref":
        svc = RegionAllocator_j(repro.Weights(*W), cells_per_batch=2,
                                min_bucket=8, spec=repro.SolverSpec(**SPEC))
    else:
        svc = RegionAllocator(rt.Weights(*W), cells_per_batch=2,
                              min_bucket=8, spec=rt.SolverSpec(**SPEC),
                              device="cpu")
    for cid, n, seed in trace:
        svc.submit(requests(cid, n, seed=seed)[0 if which == "ref" else 1])
    return svc.flush()


def trace_events(trace, which):
    o = obs_j if which == "ref" else obs
    rec = o.MemoryRecorder()
    with o.recording(rec):
        out = serve(trace, which)
    return rec.events, out


# request-point fields that are solver arithmetic: compared with a
# tolerance below (sp2_evals under Queue 3's slack); everything else of the
# timing-stripped stream must be equal
_NUMERIC = ("sp2_evals", "residual")


def test_serve_trace_emits_the_reference_stream():
    trace = cells([5, 7, 8])
    ev_t, out_t = trace_events(trace, "port")
    ev_j, _ = trace_events(trace, "ref")
    names = {e["name"] for e in ev_t}
    assert {"solve", "plan", "dispatch", "materialize", "stage",
            "request"} <= names
    st_t = [obs.strip_timing(e) for e in ev_t]
    st_j = [obs_j.strip_timing(e) for e in ev_j]
    assert len(st_t) == len(st_j)
    for a, b in zip(st_t, st_j):
        assert set(a) == set(b)
        assert {k: v for k, v in a.items() if k not in _NUMERIC} \
            == {k: v for k, v in b.items() if k not in _NUMERIC}
        if a["name"] == "request":
            assert abs(a["sp2_evals"] - b["sp2_evals"]) \
                <= EV_SLACK_PER_ITER * b["bcd_iters"]
            assert a["residual"] == pytest.approx(b["residual"], rel=1e-6,
                                                  abs=1e-12)
    reqs = [e for e in ev_t if e["name"] == "request"]
    assert {e["cell_id"] for e in reqs} == {c for c, _, _ in trace}
    for r in reqs:
        assert r["bcd_iters"] == r["iters"] and r["latency_s"] >= 0.0
        assert r["iters"] == out_t[r["cell_id"]].iters
    assert all(e["topology"] == "bcd_fleet" for e in ev_t
               if e["name"] == "solve")


def test_same_seed_runs_emit_identical_streams():
    trace = cells([5, 7, 8, 9])
    ev1 = [obs.strip_timing(e) for e in trace_events(trace, "port")[0]]
    ev2 = [obs.strip_timing(e) for e in trace_events(trace, "port")[0]]
    assert ev1 == ev2 and len(ev1) > 0


def test_recorder_changes_no_bit_launch_or_host_read(monkeypatch):
    """The reference guards that a recorder adds no compiled shape; the
    port's counterpart: the same trace with the recorder off and on gives
    the same bits, `sp1_lambda_sum` calls and host reads. On the CPU the
    `kernels.ops` entry runs the plain version, so its calls are counted
    there (the CUDA wrapper's `launches` counts the card's)."""
    calls = [0]
    entry = kops.sp1_lambda_sum

    def counted(*a):
        calls[0] += 1
        return entry(*a)

    monkeypatch.setattr(kops, "sp1_lambda_sum", counted)
    trace = cells([5, 7, 8, 9], seed=7)
    runs = []
    for on in (False, True):
        calls[0] = 0
        while_cells.host_reads = 0
        out = trace_events(trace, "port")[1] if on else serve(trace, "port")
        runs.append((out, calls[0], while_cells.host_reads))
    (a, la, ra), (b, lb, rb) = runs
    assert la == lb > 0 and ra == rb > 0
    assert list(a) == list(b)
    for cid in a:
        assert a[cid].iters == b[cid].iters
        assert a[cid].objective == b[cid].objective
        assert torch.equal(a[cid].allocation.bandwidth,
                           b[cid].allocation.bandwidth)
        assert torch.equal(a[cid].allocation.power, b[cid].allocation.power)


def test_solve_span_topology_labels():
    from repro_torch.api.solve import _topology_label

    sysp = rt.make_system(0, 8, device="cpu", dtype=torch.float64)
    fleet = rt.make_fleet(0, 2, 16, device="cpu", dtype=torch.float64)
    mesh = rt.region_mesh(devices=["cpu"])
    w = rt.Weights(*W)
    cases = [(rt.Problem(system=sysp, weights=w), "bcd"),
             (rt.Problem(system=fleet, weights=w), "bcd_fleet"),
             (rt.Problem(system=fleet, weights=w, deadline=200.0),
              "fixed_fleet"),
             (rt.Problem(system=fleet, weights=w, mesh=mesh), "bcd_region"),
             (rt.Problem(system=fleet, weights=w, rounds=rt.RoundsConfig(
                 rounds=1), key=0, mesh=mesh), "rounds_region"),
             (rt.Problem(system=fleet, weights=w, assoc=object()), "assoc")]
    for p, want in cases:
        assert _topology_label(p) == want
    rec = obs.MemoryRecorder()
    with obs.recording(rec):
        rt.solve(cases[3][0], rt.SolverSpec(**SPEC))
    assert [e["topology"] for e in rec.events if e["name"] == "solve"] \
        == ["bcd_region"]
