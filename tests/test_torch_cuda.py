"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where there is no CUDA device;
the file imports neither JAX nor `repro`, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import make_fleet
from repro_torch.core.accuracy import default_accuracy
from repro_torch.core.sp1 import _coeffs, _sp1_bounds, _sweep_consts
from repro_torch.core.types import Weights
from repro_torch.kernels import sp1_sweep


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def sweep_inputs(device, dtype, n, w=(0.5, 0.5, 1.0), cells=3, points=16):
    """Kernel inputs for `cells` cells at the equal-split start, with a
    geometric T-grid from 1.01x the slowest floor (off the attainability
    edge, where float32 rounding decides a tie)."""
    sysp = make_fleet(11, cells, n, device=device, dtype=dtype,
                      bandwidth_total=20e6 * n / 50)
    from repro_torch.core.bcd import initial_allocation
    from repro_torch.core.energy import rate

    a = initial_allocation(sysp)
    tt = sysp.bits / torch.clamp_min(rate(sysp, a.bandwidth, a.power), 1e-12)
    w1, w2, rho = (x / (w[0] + w[1]) for x in w)
    wt = Weights(w1, max(w2, 1e-9), rho)
    _, q = _coeffs(sysp, wt)
    lam_hi, _, T_lo, _ = _sp1_bounds(sysp, wt, q, tt)
    consts = _sweep_consts(sysp, wt, default_accuracy(), lam_hi)
    ramp = torch.logspace(0, math.log10(1e4), points, dtype=dtype,
                          device=device)
    T_grid = (T_lo * 1.01 * ramp).contiguous()
    return T_grid, q.contiguous(), tt.contiguous(), consts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, w", [(5, (0.5, 0.5, 1.0)), (1500, (0.5, 0.5, 1.0)),
                                  (2048, (0.5, 0.5, 1.0)),
                                  (1500, (0.0, 1.0, 1.0))])
def test_sp1_lambda_sum_matches_plain_version(cuda, dtype, n, w):
    xs = sweep_inputs(cuda, dtype, n, w)
    launches = sp1_sweep.sp1_lambda_sum.launches
    out = sp1_sweep.sp1_lambda_sum(*xs)
    again = sp1_sweep.sp1_lambda_sum(*xs)
    plain = sp1_sweep.sp1_lambda_sum_ref(*xs)
    torch.cuda.synchronize()
    assert sp1_sweep.sp1_lambda_sum.launches == launches + 2
    assert torch.equal(out, again)     # fixed-order sums: bitwise repeatable
    assert bool(torch.isfinite(out).all())
    if dtype == torch.float64:
        scale, tol = plain.abs().clamp_min(torch.finfo(dtype).tiny), 1e-10
    else:
        scale, tol = torch.maximum(plain.abs(), 1e-6 * xs[3][:, 6:7] * n), 1e-4
    assert float(((out - plain).abs() / scale).max()) <= tol


@pytest.mark.cuda
def test_sp1_lambda_sum_rejects_bad_inputs(cuda):
    T, q, tt, consts = sweep_inputs(cuda, torch.float32, 64)
    with pytest.raises(TypeError):
        sp1_sweep.sp1_lambda_sum(T.double(), q, tt, consts)
    with pytest.raises(ValueError):
        sp1_sweep.sp1_lambda_sum(T, q[:, :32], tt, consts)
    with pytest.raises(ValueError):
        sp1_sweep.sp1_lambda_sum(T, q.cpu(), tt, consts)


@pytest.mark.cuda
def test_solve_on_the_card_runs_the_kernel(cuda):
    from repro_torch import Problem, SolverSpec, solve

    sysp = make_fleet(3, 4, 256, device=cuda, dtype=torch.float64,
                      bandwidth_total=20e6 * 256 / 50)
    sp1_sweep.sp1_lambda_sum.launches = 0
    res = solve(Problem(system=sysp, weights=Weights(0.5, 0.5, 1.0)),
                SolverSpec(max_iters=8))
    assert sp1_sweep.sp1_lambda_sum.launches == 3 * int(res.iters.max())
    cpu = solve(Problem(system=sysp.to("cpu"),
                        weights=Weights(0.5, 0.5, 1.0)),
                SolverSpec(max_iters=8))
    np.testing.assert_allclose(res.objective.cpu().numpy(),
                               cpu.objective.numpy(), rtol=1e-8)
    assert torch.equal(res.iters.cpu(), cpu.iters)
