"""The harness on the CPU: cells find their files by name, added files are
picked up, the trace and roofline arithmetic, a run without a card, and the
check: a sound run is correct, the control and each fault the
cells can have are not. The `cuda` test runs a small cell on the card."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from harness import cell, roofline, spec, trace
from harness.cell import Run

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


# --- found by name -----------------------------------------------------------

@pytest.mark.parametrize("w", BENCHMARK["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(w):
    files = {c["name"]: c["file"] for c in BENCHMARK["configs"]}
    assert (ROOT / files[w["config"]]) == BENCH / "configs" / \
        f"{w['config']}.json"
    cfg = spec.config(w["config"])
    assert cfg["source"] and isinstance(cfg["reduced"], list)
    kind = spec.kind(spec.traffic(w["traffic"])["kind"])
    assert all(callable(getattr(kind, f))
               for f in ("call", "stats", "reference", "gaps"))
    assert spec.limits(w["name"])
    for traced in (False, True):
        for m in spec.metrics_of(BENCHMARK, w["name"], traced):
            assert callable(spec.reader(m["name"]))


def test_every_metric_is_a_reader():
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    assert {m["name"] for m in BENCHMARK["end_to_end"]} \
        == {"alloc_s", "alloc_peak_gib", "setup_s"}


BASE = BENCHMARK["configs"][0]["name"]


def tiny_bench(tmp_path, cells=3, devices=32, mix="free", kind=None,
               limits=None):
    """A copy of the benchmark's data with one more configuration, mix (the
    mix `mix`, of kind `kind` if given), limits file and cell, none of
    which the harness's code names."""
    bench_dir = tmp_path / "cardbench"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = spec.config(BASE)
    cfg.update(cells=cells, devices_per_cell=devices,
               bandwidth_total_hz=20e6 * devices / 50)
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(cfg))
    data = dict(spec.traffic(mix), pool=2)
    kind = kind or data["kind"]
    data["kind"] = kind
    (bench_dir / "traffic" / f"tiny-{kind}.json").write_text(json.dumps(data))
    name = f"tiny.{kind}"
    limits = limits or {k: 1.0 for k in ("objective", "budget", "bandwidth",
                                         "power", "freq", "resolution")}
    (bench_dir / "limits" / f"{name}.json").write_text(json.dumps(limits))
    bench = json.loads(json.dumps(BENCHMARK))
    bench["workloads"].append({"name": name, "config": "tiny",
                               "traffic": f"tiny-{kind}", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"] + bench["end_to_end"]:
        m.get("workloads", []).append(name)
    return bench_dir, bench, name


def test_added_files_are_picked_up(tmp_path, monkeypatch):
    bench_dir, bench, name = tiny_bench(tmp_path)
    monkeypatch.setattr(spec, "BENCH_DIR", bench_dir)
    for traced in (False, True):
        out = cell.run(name, 2 ** 31 + 12345, 0.0, traced,
                       time.perf_counter(), device="cpu", bench=bench)
        assert out["correct"] is True
        assert out["attempted"] == 2          # one pass over the pool
        assert list(out)[-1] == "checks"
        if traced:
            assert {"bcd_iters", "host_reads", "sp2_evals"} \
                <= set(out["metrics"])
            assert "idle_share" not in out["metrics"]   # no device events
        else:       # no card memory on the CPU: alloc_peak_gib reads none
            assert set(out["metrics"]) == {"alloc_s", "setup_s"}


def test_an_added_kind_and_metric_are_picked_up(tmp_path, monkeypatch):
    """A new kind (`kinds/<kind>.py`) and a new end-to-end metric
    (`metrics/<metric>.py`) are new files and entries, no edit."""
    bench_dir, bench, name = tiny_bench(tmp_path, kind="twice")
    (bench_dir / "kinds" / "twice.py").write_text(
        (BENCH / "kinds" / "free.py").read_text()
        + "\n\ndef stats(answer):\n"
        "    return torch.cat([torch.stack([answer['iters'].double().amax(),"
        "\n        answer['sp2_evals'].double().mean()])[:, None]] * 2, -1)\n")
    (bench_dir / "metrics" / "window_calls.py").write_text(
        "def read(run):\n    return run.window_s * 0 + run.allocations\n")
    bench["end_to_end"].append({"name": "window_calls", "unit": "calls",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock"})
    monkeypatch.setattr(spec, "BENCH_DIR", bench_dir)
    out = cell.run(name, 3, 0.0, False, time.perf_counter(), device="cpu",
                   bench=bench)
    assert out["correct"] is True
    assert out["attempted"] == 4          # two allocations a call
    assert out["metrics"]["window_calls"]["value"] == 4


def test_seeds_permute_the_same_work(tmp_path, monkeypatch):
    from harness import traffic
    bench_dir, bench, name = tiny_bench(tmp_path)
    monkeypatch.setattr(spec, "BENCH_DIR", bench_dir)
    cfg, mix = spec.config("tiny"), spec.traffic("tiny-free")
    a = traffic.build(cfg, mix, 1, "cpu")
    b = traffic.build(cfg, mix, 2 ** 33 + 7, "cpu")
    again = traffic.build(cfg, mix, 1, "cpu")
    assert all(torch.equal(x.gain, y.gain)
               for x, y in zip(a.pool, again.pool))
    rows = lambda wl: sorted(tuple(r.tolist()) for s in wl.pool  # noqa: E731
                             for r in s.gain)
    assert rows(a) == rows(b)             # the same cells, bit for bit
    assert not torch.equal(a.pool[0].gain, b.pool[0].gain)


# --- the trace's arithmetic ----------------------------------------------------

def test_idle_share_and_breakdown_on_a_synthetic_trace():
    device = [("k1", 0, 10), ("k2", 5, 15), ("Memcpy DtoH", 20, 25),
              ("k1", 40, 50)]
    host = [(0, 100, "cardbench.solve"), (14, 22, "aten::item"),
            (26, 39, "aten::where"), (30, 33, "cudaLaunchKernel")]
    spans = [(0, 100, "cardbench.solve")]
    r = trace.reduce(device, host, spans, window_ns=100)
    assert r["busy_s"] == pytest.approx(30e-9)      # [0, 15] + [20, 25] + [40, 50]
    assert r["window_s"] == pytest.approx(100e-9)
    assert r["launches"] == 3                       # the copy is no kernel
    assert r["kernels"]["k1"] == [2, pytest.approx(20e-9)]
    assert r["breakdown"]["device_ops"][0] == ["k1", pytest.approx(20e-9)]
    gaps = dict(r["breakdown"]["idle_gaps"])
    # the gap (15, 20) has its middle in aten::item; (25, 40) in
    # cudaLaunchKernel inside aten::where
    assert gaps == {"solve/aten::item": pytest.approx(5e-9),
                    "solve/cudaLaunchKernel": pytest.approx(15e-9)}
    run = Run(dtype="float32", trace=r, traced_allocations=2)
    assert spec.reader("idle_share")(run) == pytest.approx(70.0)
    assert spec.reader("launches")(run) == pytest.approx(1.5)


def test_python_gaps_and_union():
    total, gaps = trace.union_length([(0, 4), (1, 2), (6, 8)])
    assert total == 6 and gaps == [(4, 6)]
    assert trace.innermost([(0, 3, "a")], [1, 5]) == ["a", "python"]


# --- the sweep's work -----------------------------------------------------------

def sweep_inputs(C=3, M=5, N=7, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.rand((C, N), generator=g) * 1e-3 + 1e-4
    tt = torch.rand((C, N), generator=g) * 1e-2
    consts = torch.zeros((C, 8))
    consts[:, 3] = 2e9                  # f_max
    consts[:, 4] = 160.0                # s_lo
    T = torch.sort(torch.rand((C, M), generator=g) * 2e-2, -1).values
    return T, q, tt, consts


def test_sp1_work_is_the_frozen_formula():
    T, q, tt, consts = sweep_inputs()
    C, M = T.shape
    N = q.shape[1]
    t_c = torch.clamp_min(T[:, :, None] - tt[:, None, :],
                          torch.finfo(q.dtype).tiny)
    floor = q[:, None, :] * 160.0 ** 2 / 2e9
    sat = int((floor > t_c).sum())
    assert 0 < sat < C * M * N
    ops, moved = roofline.sp1_work(torch, T, q, tt, consts)
    assert ops == 171 * (C * M * N - sat) + 5 * sat + 20 * C * N + 21 * C
    assert moved == 4 * (2 * C * M + 2 * C * N + 8 * C)
    assert (roofline.SP1_OPS_PER_PAIR, roofline.SP1_OPS_PER_SATURATED_PAIR,
            roofline.SP1_OPS_PER_DEVICE, roofline.SP1_OPS_PER_CELL) \
        == (171, 5, 20, 21)


def test_roofline_reader():
    run = Run(dtype="float32", trace={"kernels": {
        "void (anonymous namespace)::sp1_partial_kernel<float>": [3, 2e-3],
        "void (anonymous namespace)::sp1_final_kernel<float>": [3, 1e-3],
        "elementwise": [9, 1.0]}}, sp1_work=[(67e9, 1e3)] * 3)
    # 3 x 67e9 operations at 67 TFLOP/s = 3 ms of bound in 3 ms of kernel
    assert spec.reader("sp1_lambda_sum.roofline")(run) == pytest.approx(100.0)
    run.sp1_work = None
    assert spec.reader("sp1_lambda_sum.roofline")(run) is None


# --- no card, no result -----------------------------------------------------

def test_a_run_without_a_card_fails_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         BENCHMARK["workloads"][0]["name"], "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


# --- the check: sound, control, faults ----------------------------------------

CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def check_run(tmp_path, monkeypatch, workload, call=None):
    """One call a pool fleet of a tiny cell of the paper's 50 devices under
    `workload`'s mix, judged by that cell's own limits; `call` replaces the
    program's unit of work (the control)."""
    mix = spec.cell(BENCHMARK, workload)["traffic"]
    bench_dir, bench, name = tiny_bench(tmp_path, 16, 50, mix,
                                        limits=spec.limits(workload))
    monkeypatch.setattr(spec, "BENCH_DIR", bench_dir)
    return cell.run(name, 2 ** 32 + 99, 0.0, False, time.perf_counter(),
                    device="cpu", bench=bench, call=call,
                    cover_pool=call is not None)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(tmp_path, monkeypatch, workload):
    assert check_run(tmp_path, monkeypatch, workload)["correct"] is True


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(tmp_path, monkeypatch, workload):
    import readings
    out = check_run(tmp_path, monkeypatch, workload, readings.control_call)
    assert out["correct"] is False


def unchanged_step(real):
    def fault(state0, max_iters, ncols, tol, step, mask=None):
        return real(state0, max_iters, ncols, tol,
                    lambda st: (st, step(st)[1]), mask)
    return fault


def half_the_cells(real):
    def fault(state0, max_iters, ncols, tol, step, mask=None):
        def half(st):
            new, metrics = step(st)
            C = st[0].shape[0]
            keep = (torch.arange(C) < C // 2)[:, None]
            return tuple(torch.where(keep, a, b)
                         for a, b in zip(new, st)), metrics
        return real(state0, max_iters, ncols, tol, half, mask)
    return fault


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [unchanged_step, half_the_cells])
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, fault,
                                      workload):
    from repro_torch.core import bcd
    monkeypatch.setattr(bcd, "_bcd_while", fault(bcd._bcd_while))
    assert check_run(tmp_path, monkeypatch, workload)["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_an_altered_answer_is_not_correct(tmp_path, monkeypatch, workload):
    api = sys.modules["repro_torch.api.solve"]
    real = api._fleet_result

    def altered(out, *args, **kw):
        res = real(out, *args, **kw)
        res.allocation.freq = res.allocation.freq * (1.0 + 1e-2)
        return res

    monkeypatch.setattr(api, "_fleet_result", altered)
    assert check_run(tmp_path, monkeypatch, workload)["correct"] is False


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_a_small_cell_on_the_card(tmp_path, monkeypatch, card):
    bench_dir, bench, name = tiny_bench(tmp_path, cells=8, devices=256)
    monkeypatch.setattr(spec, "BENCH_DIR", bench_dir)
    out = cell.run(name, 5, 0.0, True, time.perf_counter(), device="cuda",
                   bench=bench)
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert 0 < out["metrics"]["idle_share"]["value"] < 100


def test_jax_in_the_process_is_found_by_whole_name(monkeypatch):
    import types
    assert cell.banned_modules() == []          # the port is not `repro`
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jnp"))
    assert cell.banned_modules() == ["jax"]
