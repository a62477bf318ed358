"""Batched SP1 dual sweep: Sigma_n lambda_n(T) over a whole T-grid, per cell.

Port of `repro/kernels/sp1_sweep.py` (the Pallas kernel `sp1_lambda_sum`).
SP1's KKT system (paper eqs. A.2-A.7) is solved by inverting the
per-device makespan map lambda -> T_n(lambda) and finding the T at which
Sigma_n lambda_n(T) = w2 Rg. For the paper's LinearAccuracy the inversion
is exact and closed form (see `lambda_of_T_linear`).

Two versions of one function live here:

  * `lambda_of_T_linear` / `sp1_lambda_sum_ref`: plain PyTorch. The CPU
    path and the reference the CUDA kernel is held against.
  * `sp1_lambda_sum`: the wrapper of the hand-written CUDA kernel in
    `csrc/sp1_sweep.cu` (built by `kernels.build`). CUDA tensors only; it
    counts its launches in `sp1_lambda_sum.launches`.

Both take the batched form the fleet solve uses: T_grid (C, M),
q / tt (C, N), consts (C, N_CONSTS) -> (C, M), one row per cell, where the
TPU kernel took one cell per call under `jax.vmap`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

Tensor = torch.Tensor

# consts row layout: index -> meaning
N_CONSTS = 8   # [k3, rho_slope, f_min, f_max, s_lo, s_hi, lam_hi, unused]
# devices per CUDA block (one per thread); a power of two from 32 to 256, as
# the C entry requires
BLOCK_N = 256


def _cbrt(x: Tensor) -> Tensor:
    """Real cube root of x >= 0 (every caller guarantees the sign). PyTorch
    has no cbrt; x**(1/3) can differ from a true cbrt (`jnp.cbrt`, CUDA's
    `cbrt`) by an ulp or so, since 1/3 is not exact."""
    return x.pow(1.0 / 3.0)


def _clip(x: Tensor, lo, hi) -> Tensor:
    """jnp.clip: minimum(maximum(x, lo), hi), NaN-propagating like jnp."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def lambda_of_T_linear(T, q, tt, k3, rhok, f_min, f_max, s_lo, s_hi, lam_hi):
    """Exact lambda_n(T) for LinearAccuracy; broadcasts over any shared
    shape of (T, q, tt) and the coefficients.

    Enumerates the clipping regimes of (f, s):
      f = F in {fmin, fmax}, s interior:  s = sqrt(t_c F / q),
          lam = (rhok/s - 2 alpha F^2) F / (2 q)
      s = S in {s_lo, s_hi}, f interior:  f = q S^2 / t_c, lam = k3 f^3
      both interior:  psi = 6 alpha f^2  =>  f^5 = q rhok^2 / (36 alpha^2 t_c)
    plus lam = 0 (device already meets the deadline). Candidates are clipped
    to [0, lam_hi] (nan -> lam_hi), validated through the exact forward
    makespan, and the smallest lambda among the error-minimizing candidates
    is returned; an unattainable deadline saturates to lam_hi.
    """
    dt = q.dtype
    # dtype-aware guard: a literal 1e-300 underflows to 0 in f32, and
    # w1 == 0 (k3 == 0) would turn the lam=0 candidate into cbrt(0/0)
    tiny = torch.finfo(dt).tiny
    t_c = torch.clamp_min(T - tt, tiny)          # target compute time
    q_safe = torch.clamp_min(q, tiny)
    alpha = 0.5 * k3 * q
    k3_safe = torch.clamp_min(k3, tiny)

    def makespan_err(lam):                       # exact forward map, vs target
        f = _clip(_cbrt(lam / k3_safe), f_min, f_max)
        fs = torch.clamp_min(f, 1e-9)
        psi = 2.0 * alpha * (f * f) + 2.0 * lam * q / fs
        s = _clip(rhok / torch.clamp_min(psi, tiny), s_lo, s_hi)
        return torch.abs(q * (s * s) / fs - t_c)

    def cand_f_clipped(F):                       # f pinned at a box edge
        s = torch.sqrt(t_c * F / q_safe)
        return (rhok / torch.clamp_min(s, tiny) - 2.0 * alpha * (F * F)) \
            * F / (2.0 * q_safe)

    def cand_s_clipped(S):                       # s pinned at a box edge
        f = q * (S * S) / t_c
        return k3 * (f * f * f)

    # both interior, factored so kappa-scale coefficients never square:
    # alpha^2 ~ 1e-45 underflows f32 even though f itself is representable
    f6 = (rhok / torch.clamp_min(3.0 * k3, tiny)) ** 0.4 \
        * torch.clamp_min(q * t_c, tiny) ** -0.2
    cands = torch.stack(torch.broadcast_tensors(
        torch.zeros_like(t_c),
        cand_f_clipped(f_min), cand_f_clipped(f_max),
        cand_s_clipped(s_lo), cand_s_clipped(s_hi),
        k3 * (f6 * f6 * f6)))
    lam_hi = torch.as_tensor(lam_hi, dtype=dt, device=q.device)
    cands = torch.where(torch.isnan(cands), lam_hi, _clip(cands, 0.0, lam_hi))
    err = makespan_err(cands)
    best = err.amin(0)
    near = err <= best * (1.0 + 1e-6) + tiny
    inf = torch.full((), float("inf"), dtype=dt, device=q.device)
    lam = torch.where(near, cands, inf).amin(0)
    # strictly unattainable deadline: saturate like the bisection does
    floor = q * (s_lo * s_lo) / torch.clamp_min(
        torch.as_tensor(f_max, dtype=dt, device=q.device), 1e-9)
    return torch.where(floor > t_c, lam_hi, lam)


def sp1_lambda_sum_ref(T_grid: Tensor, q: Tensor, tt: Tensor,
                       consts: Tensor) -> Tensor:
    """Plain PyTorch Sigma_n lambda_n(T): T_grid (C, M), q / tt (C, N),
    consts (C, N_CONSTS) -> (C, M), in the inputs' dtype."""
    k = [consts[:, i, None, None] for i in range(7)]
    lam = lambda_of_T_linear(T_grid[:, :, None], q[:, None, :],
                             tt[:, None, :], *k)
    return lam.sum(-1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("sp1_sweep")
    for fn in (lib.sp1_lambda_sum_f32, lib.sp1_lambda_sum_f64):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.sp1_error_string.argtypes = [ctypes.c_int]
    lib.sp1_error_string.restype = ctypes.c_char_p
    return lib


def _check(T_grid: Tensor, q: Tensor, tt: Tensor, consts: Tensor):
    ts = (T_grid, q, tt, consts)
    if any(t.device.type != "cuda" or t.device != T_grid.device for t in ts):
        raise ValueError("sp1_lambda_sum: every tensor must be on one CUDA "
                         "device")
    if T_grid.dtype not in (torch.float32, torch.float64) \
            or any(t.dtype != T_grid.dtype for t in ts):
        raise TypeError("sp1_lambda_sum: tensors must share float32 or "
                        f"float64, got {[t.dtype for t in ts]}")
    if any(t.ndim != 2 or not t.is_contiguous() for t in ts):
        raise ValueError("sp1_lambda_sum: tensors must be contiguous 2-D")
    C, M = T_grid.shape
    N = q.shape[1]
    if q.shape != (C, N) or tt.shape != (C, N) or consts.shape != (C, N_CONSTS):
        raise ValueError(
            f"sp1_lambda_sum: shapes T_grid {tuple(T_grid.shape)}, q "
            f"{tuple(q.shape)}, tt {tuple(tt.shape)}, consts "
            f"{tuple(consts.shape)} do not fit (C, M), (C, N), (C, N), "
            f"(C, {N_CONSTS})")
    if not (0 < C <= 65535 and M > 0 and N > 0):
        raise ValueError(f"sp1_lambda_sum: need 0 < C <= 65535, M > 0, N > 0; "
                         f"got C={C}, M={M}, N={N}")


def sp1_lambda_sum(T_grid: Tensor, q: Tensor, tt: Tensor,
                   consts: Tensor) -> Tensor:
    """CUDA kernel: Sigma_n lambda_n(T) per cell and candidate, (C, M).

    One launch covers every cell. The sum over devices runs in a fixed
    order (a shuffle butterfly in each warp, then the warps in order, then
    the blocks in index order), so equal inputs give bitwise equal sums on
    every run. Lanes past N add exactly 0.
    """
    _check(T_grid, q, tt, consts)
    C, M = T_grid.shape
    N = q.shape[1]
    n_chunks = -(-N // BLOCK_N)
    partials = torch.empty((C, n_chunks, M), dtype=q.dtype, device=q.device)
    out = torch.empty((C, M), dtype=q.dtype, device=q.device)
    lib = _lib()
    fn = lib.sp1_lambda_sum_f32 if q.dtype == torch.float32 \
        else lib.sp1_lambda_sum_f64
    with torch.cuda.device(q.device):
        rc = fn(T_grid.data_ptr(), q.data_ptr(), tt.data_ptr(),
                consts.data_ptr(), partials.data_ptr(), out.data_ptr(),
                C, M, N, BLOCK_N,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("sp1_lambda_sum: kernel launch failed: "
                           + lib.sp1_error_string(rc).decode())
    sp1_lambda_sum.launches += 1
    return out


sp1_lambda_sum.launches = 0
