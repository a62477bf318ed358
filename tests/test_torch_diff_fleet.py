"""`repro_torch.diff.solve_and_grad` against `repro.diff.solve_and_grad` on
the CPU, float64: the per-cell-weights fleet of tests/test_diff_grad.py
(one batched graph over the three cells), a fleet carrying a padded cell,
and the exact dense adjoint (`adjoint_iters=0`)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import repro
from repro.diff import solve_and_grad as solve_and_grad_j

import repro_torch as rt
from repro_torch.diff import METRICS, solve_and_grad

from _torch_diff import LEAVES, SPEC, compare_grads, problems


def test_fleet_grads_match_repro():
    pj, pt = problems("fleet")
    gj = solve_and_grad_j(pj, repro.SolverSpec(**SPEC), wrt=LEAVES)
    gt = solve_and_grad(pt, rt.SolverSpec(**SPEC), wrt=LEAVES)
    compare_grads(gt, gj, LEAVES)
    for m in METRICS:
        assert gt.value[m].shape == (3,)
        assert gt.grads[m]["weights"].shape == (3, 3)
        assert gt.grads[m]["kappa"].shape == (3, 1)
        assert gt.grads[m]["cycles"].shape == (3, 8)
    assert gt.allocation.bandwidth.shape == (3, 8)
    assert gt.allocation.T.shape == (3,)


def test_dense_adjoint_matches_repro():
    """adjoint_iters=0: the exact solve of (I - Phi_x^T) u = v over each
    cell's 2N unknowns, against the reference's."""
    pj, pt = problems("single")
    spec = dict(max_iters=20)
    gj = solve_and_grad_j(pj, repro.SolverSpec(**spec), wrt=LEAVES,
                          adjoint_iters=0)
    gt = solve_and_grad(pt, rt.SolverSpec(**spec), wrt=LEAVES,
                        adjoint_iters=0)
    compare_grads(gt, gj, LEAVES)


def test_padded_fleet_pad_lanes_zero():
    """A stack of the padded cell and a full one: the padded cell's pad
    lanes get exactly zero gradient, and both cells match repro."""
    pj, pt = problems("padded")
    sj, st = pj.system, pt.system
    fj = repro.stack_systems([sj, repro.region.batch.pad_system(
        problems("single")[0].system, 8)])
    ft = rt.stack_systems([st, rt.pad_system(problems("single")[1].system,
                                             8)])
    spec = dict(max_iters=8)
    w = (0.4, 0.6, 0.3)
    gj = solve_and_grad_j(repro.Problem(system=fj, weights=repro.Weights(*w)),
                          repro.SolverSpec(**spec), wrt=LEAVES)
    gt = solve_and_grad(rt.Problem(system=ft, weights=rt.Weights(*w)),
                        rt.SolverSpec(**spec), wrt=LEAVES)
    compare_grads(gt, gj, LEAVES)
    pad = ~ft.active
    assert int(pad.sum()) == 2
    for m in METRICS:
        for leaf in ("cycles", "samples", "gain"):
            lanes = gt.grads[m][leaf][pad]
            assert torch.equal(lanes, torch.zeros_like(lanes)), (m, leaf)


def test_float32_pad_lane_grads_exactly_zero():
    """In float32 a pad lane's B = 0 puts N0 B ~ 4e-30 in a divisor whose
    square underflows in the backward pass, and repro's pad-lane gradients
    come out NaN there. The port evaluates those divisions at a safe
    bandwidth on pad lanes (`diff.implicit._with_pad_bandwidth`, values
    unchanged): exactly 0, every other gradient finite."""
    gen = torch.Generator().manual_seed(31)
    sizes = (40, 50, 60, 33)
    pool = rt.stack_systems([
        rt.pad_system(rt.make_system(gen, n, device="cpu",
                                     dtype=torch.float32,
                                     bandwidth_total=20e6 * n / 50), 64)
        for n in sizes])
    g = solve_and_grad(rt.Problem(system=pool, weights=rt.Weights(0.5, 0.5,
                                                                  1.0)),
                       rt.SolverSpec(max_iters=8),
                       wrt=("gain", "cycles", "samples", "kappa"))
    pad = ~pool.active
    for m in METRICS:
        for leaf in ("gain", "cycles", "samples"):
            lanes = g.grads[m][leaf][pad]
            assert torch.equal(lanes, torch.zeros_like(lanes)), (m, leaf)
        for v in g.grads[m].values():
            assert bool(torch.isfinite(v).all()), m
