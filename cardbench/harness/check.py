"""How `correct` is decided: the cells that each call of the window
answered, a sample drawn from the seed plus each call's hardest cells, are
solved again by the float64 reference (`reference/alg2.py`, through the
kind's `reference`) from the same inputs once the window has closed, and
the program's answers are held to the reference's by the kind's numbers
(`gaps`), each against the cell's limit (`limits/<workload>.json`).

Cells of a fleet are independent problems (every operation of the solve is
per cell, and a finished cell's state is frozen while the others go on), so
the sampled rows of a call are judged as the call answered them, and the
reference solves the rows of every call of the window as one batch.

A device whose relaxed resolution sits within float32's rounding of a
menu midpoint rounds the other way now and then, and its cell's answer
moves by up to ~2e-2 (PERF.md); hence medians (`typical`) for per-device
variables, and the largest (`worst`) for the objective, which such a move
barely shifts. A cell's limits file names the numbers it compares.
"""
from __future__ import annotations

import math

import torch

from reference.alg2 import ARRAYS, SCALARS, System

SAMPLE_DEVICES = 16384   # devices of random cells sampled from each call
MIN_SAMPLE_CELLS = 8
HARDEST = 2              # plus the cells that took the most BCD iterations


def effective_tol(cfg: dict) -> float:
    """The BCD tolerance as the configuration's solve applies it: the
    default 1e-6 floored at 64 ulps of the configuration's dtype."""
    eps = torch.finfo(getattr(torch, cfg["dtype"])).eps
    return max(float(cfg.get("tol", 1e-6)), 64.0 * eps)


def sample_size(cfg: dict) -> int:
    C, N = int(cfg["cells"]), int(cfg["devices_per_cell"])
    return min(C, max(MIN_SAMPLE_CELLS, SAMPLE_DEVICES // N))


def take(answer: dict, gen: torch.Generator, cfg: dict) -> dict:
    """The sampled rows of one call's answer, gathered on the device (no
    host read): `cells` holds the row indices. The hardest cells are those
    with the most BCD iterations, then SP2 evaluations."""
    C = int(cfg["cells"])
    dev = answer["iters"].device
    rand = torch.randperm(C, generator=gen, device=dev)[:sample_size(cfg)]
    effort = answer["iters"].double() * 1e9 + answer["sp2_evals"].double()
    rows = torch.cat([rand, effort.topk(min(HARDEST, C)).indices])
    out = {name: x.index_select(0, rows) for name, x in answer.items()}
    out["cells"] = rows
    return out


def cat_systems(parts) -> System:
    return parts[0].replace(**{k: torch.cat([getattr(p, k) for p in parts])
                               for k in ARRAYS + SCALARS})


def reference_inputs(samples, device) -> System:
    """The sampled rows of every call, as one float64 system."""
    return cat_systems([sys.rows(s["cells"].to(device)).to(
        dtype=torch.float64, device=device) for sys, s in samples])


def program_rows(samples) -> dict:
    """The program's sampled answers of every call, as one batch."""
    keys = [k for k in samples[0] if k != "cells"]
    return {k: torch.cat([s[k] for s in samples]) for k in keys}


def rel_l2(x, ref) -> torch.Tensor:
    """||x - ref|| / ||ref|| of each row, over the last axis."""
    x, ref = x.double(), ref.double()
    return torch.linalg.vector_norm(x - ref, dim=-1) / torch.clamp_min(
        torch.linalg.vector_norm(ref, dim=-1), 1e-300)


def rel(x, ref) -> torch.Tensor:
    x, ref = x.double(), ref.double()
    return (x - ref).abs() / torch.clamp_min(ref.abs(), 1e-300)


def typical(t: torch.Tensor) -> float:
    """The median gap over the sampled cells: what a cell's answer reads
    when no resolution sits on a rounding boundary (a device whose
    resolution rounds the other way in float32 moves its whole cell)."""
    t = torch.nan_to_num(t.double(), nan=math.inf)
    return float(t.median()) if t.numel() else 0.0


def worst(t: torch.Tensor) -> float:
    """The largest gap; NaN (a non-finite answer) reads as infinite."""
    t = torch.nan_to_num(t.double(), nan=math.inf)
    return float(t.max()) if t.numel() else 0.0


def judge(values: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): each number the cell compares
    (those its limits name) at most its limit."""
    rows = [(k, values[k], float(lim)) for k, lim in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows
