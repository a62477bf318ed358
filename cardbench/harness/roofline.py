"""The yardstick's peaks and the sweep kernel's work, counted from its
inputs whatever implements it.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no sparsity) at
its full 700 W limit: 67 TFLOP/s float32 outside the tensor cores,
3.35 TB/s of HBM3.

`sp1_ops` is a frozen copy of the operation count of the SP1 dual sweep
Sigma_n lambda_n(T) (the allocator's `lambda_of_T_linear`, one pass per
(grid point, device) pair), counting each add, multiply, divide,
compare-and-select, sqrt, cbrt and pow as one, each where it first can be
formed: per pair, per device or per cell. The clip-and-validate of a
candidate is 24: the NaN select 1, the clip to [0, lam_hi] 2, lam / k3 1,
cbrt 1, the f clip 2, max(f, 1e-9) 1, psi 7, max(psi, tiny) 1, rhok / psi
1, the s clip 2, q s^2 / fs 3, the difference from t_c and its magnitude 2.
Per pair: t_c 2; per f-clipped candidate 8; per s-clipped one 4; the
interior one 7; the lambda = 0 candidate's |mk0 - t_c| 2; the other five
validates less 2 alpha, 23 each; the pick 18; the unattainable test 2; the
sum 1. A pair whose deadline is unattainable (makespan floor > t_c) needs
only t_c, the test, the select and the sum.
"""
from __future__ import annotations

PEAK_OPS_S = {"float32": 67e12}
HBM_BYTES_S = 3.35e12

SP1_OPS_PER_PAIR = 2 + 2 * 8 + 2 * 4 + 7 + 2 + 5 * 23 + 18 + 2 + 1
SP1_OPS_PER_SATURATED_PAIR = 2 + 2 + 1
SP1_OPS_PER_DEVICE = 1 + 1 + 1 + 2 + 1 + 2 + 1 + 11
SP1_OPS_PER_CELL = 1 + 1 + 2 + 2 + 4 + 1 + 8 + 1 + 1

# consts row: [k3, rho_slope, f_min, f_max, s_lo, s_hi, lam_hi, unused]
CONST_F_MAX, CONST_S_LO = 3, 4


def sp1_saturated(torch, T_grid, q, tt, consts) -> int:
    """The (cell, point, device) triples whose deadline no f can meet,
    by the sweep's own test, one grid point at a time."""
    tiny = torch.finfo(q.dtype).tiny
    s_lo, f_max = consts[:, CONST_S_LO:CONST_S_LO + 1], \
        consts[:, CONST_F_MAX:CONST_F_MAX + 1]
    floor = q * (s_lo * s_lo) / torch.clamp_min(f_max, 1e-9)
    n = 0
    for m in range(T_grid.shape[1]):
        t_c = torch.clamp_min(T_grid[:, m:m + 1] - tt, tiny)
        n += int((floor > t_c).sum())
    return n


def sp1_work(torch, T_grid, q, tt, consts) -> tuple:
    """(operations, bytes) one sweep call needs: T_grid (C, M), q and tt
    (C, N), consts (C, 8) read once, the (C, M) sums written once."""
    C, M = T_grid.shape
    N = q.shape[1]
    sat = sp1_saturated(torch, T_grid, q, tt, consts)
    ops = SP1_OPS_PER_PAIR * (C * M * N - sat) \
        + SP1_OPS_PER_SATURATED_PAIR * sat \
        + SP1_OPS_PER_DEVICE * C * N + SP1_OPS_PER_CELL * C
    size = q.element_size()
    moved = size * (2 * C * M + 2 * C * N + C * consts.shape[1])
    return ops, moved


def bound_s(ops: float, moved: float, dtype: str) -> float:
    """The least time the card could take: operations at the dtype's peak
    or bytes at HBM's, whichever is longer."""
    return max(ops / PEAK_OPS_S[dtype], moved / HBM_BYTES_S)
