"""What a run measures, found by name: `BENCHMARK.json` at the root of the
checkout names each cell's configuration and traffic mix. Each of those,
each traffic kind, each metric's reader and each cell's limits is a file of
its own under `cardbench/`, so that adding one is adding files:

  configs/<config>.json    the deployment's sizes, source and cuts
  traffic/<mix>.json       a mix: data that names its `kind`
  kinds/<kind>.py          a kind's unit of work, reference and comparison
  metrics/<metric>.py      `read(run)` of one metric, end to end or per layer
  limits/<workload>.json   the limit on each number a cell's check compares
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def benchmark(root: Path = None) -> dict:
    return json.loads(((root or ROOT) / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def data(folder: str, name: str) -> dict:
    return json.loads((BENCH_DIR / folder / f"{name}.json").read_text())


def config(name: str) -> dict:
    return data("configs", name)


def traffic(name: str) -> dict:
    return data("traffic", name)


def limits(workload: str) -> dict:
    """The cell's limit on each number its check compares."""
    return data("limits", workload)


def module(folder: str, name: str):
    """`<folder>/<name>.py` under the benchmark's folder, loaded by path."""
    path = BENCH_DIR / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str):
    """The module of traffic kind `name` (`kinds/<name>.py`)."""
    return module("kinds", name)


def reader(metric: str):
    """The `read(run)` function of `metrics/<metric>.py`."""
    return module("metrics", metric).read


def metrics_of(bench: dict, workload: str, traced: bool) -> list:
    """The metric entries a run of `workload` reports: the end-to-end ones
    untraced, the per-layer ones traced; an entry with `workloads` only in
    the cells it lists."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]
