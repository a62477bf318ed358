"""Batched SP2 dual sweep: g'(mu) for a whole grid of multipliers, per cell.

Port of `repro/kernels/waterfill.py` (the Pallas kernel `waterfill_gprime`,
paper eq. A.23):

    g'(mu) = Sigma_n rmin_n ln2 / max(W0((mu - j_n)/(e j_n)) + 1, eps^2)
             - B_total

The Lambert argument z = (mu - j)/(e j) sits at the branch point -1/e when
mu << j, where forming e z + 1 cancels every significant bit. Both versions
here therefore work on the cancellation-free ratio q = mu / j (e z + 1 = q
exactly) and seed the branch-point series with p = sqrt(2 q).

Two versions of one function live here:

  * `_lambertw_vec` / `waterfill_gprime_ref`: plain PyTorch. The CPU path
    and the reference the CUDA kernel is held against.
    `lambertw_early_exit` replays the kernel's early exit from the Halley
    loop (at a fixed point or a two-cycle, bit for bit) in plain PyTorch
    and counts each lane's steps.
  * `waterfill_gprime`: the wrapper of the hand-written CUDA kernel in
    `csrc/waterfill.cu` (built by `kernels.build`). CUDA tensors only; it
    counts its launches in `waterfill_gprime.launches`.

Both take the batched form: mu (C, M), j / rmin (C, N), B_total (C,) ->
(C, M), where the TPU kernel took one cell per call. A lane with rmin = 0
adds exactly 0 (the solver parks masked devices there).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

Tensor = torch.Tensor

_LN2 = math.log(2.0)
# devices per CUDA block (one per thread); a power of two, at least a warp
BLOCK_N = 256
# Halley steps of the reference's Lambert W (the kernel's cap)
HALLEY_STEPS = 24


def _lambertw_seed(q: Tensor):
    """(qc, zc, w_branch, w0): the clamped ratio, z = (qc - 1)/e, the
    branch-point series and the Halley seed of `_lambertw_vec`."""
    eps, tiny = torch.finfo(q.dtype).eps, torch.finfo(q.dtype).tiny
    qc = torch.clamp_min(q, 0.0)
    zc = (qc - 1.0) / math.e
    # branch-point series in p = sqrt(2(e z + 1)) = sqrt(2 q)
    p = torch.sqrt(2.0 * qc)
    w_branch = -1.0 + p * (1.0 - p / 3.0 + 11.0 * p * p / 72.0
                           - 43.0 * p * p * p / 540.0)
    lz = torch.log(torch.clamp_min(zc, tiny))
    llz = torch.log(torch.clamp_min(lz, tiny))
    w_big = lz - llz + llz / torch.clamp_min(lz, eps)
    w_small = zc * (1.0 - zc + 1.5 * zc * zc)
    w = torch.where(zc < -0.25, w_branch,
                    torch.where(zc > 3.0, w_big, w_small))
    return qc, zc, w_branch, torch.clamp_min(w, -1.0 + eps)


def _halley_step(w: Tensor, zc: Tensor) -> Tensor:
    """One clamped Halley step for w e^w = zc: a function of (w, zc) only."""
    eps, tiny = torch.finfo(w.dtype).eps, torch.finfo(w.dtype).tiny
    ew = torch.exp(w)
    f = w * ew - zc
    wp1 = w + 1.0
    denom = ew * wp1 - (w + 2.0) * f / (2.0 * wp1)
    return torch.clamp_min(
        w - f / torch.where(denom.abs() < tiny, tiny, denom), -1.0 + eps)


def _lambertw_vec(q: Tensor, iters: int = HALLEY_STEPS) -> Tensor:
    """W0(z) for z = (q - 1)/e, q >= 0, stable at the branch point in
    float32. The clamps follow the dtype: a float32 lane at z ~ -1/e would
    otherwise round W to exactly -1, and Halley's divisor w + 1 to 0."""
    qc, zc, w_branch, w = _lambertw_seed(q)
    for _ in range(iters):
        w = _halley_step(w, zc)
    # Halley's f = w e^w - z cancels near the branch point; there the
    # p-series is the accurate evaluation, so keep it
    return torch.where(qc < 1e-3, w_branch, w)


def _bits(x: Tensor) -> Tensor:
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def lambertw_early_exit(q: Tensor, iters: int = HALLEY_STEPS):
    """`_lambertw_vec` under the CUDA kernel's exit rule, in plain PyTorch:
    each lane stops at the first Halley step w_i that repeats w_{i-1} (a
    fixed point: w_iters = w_i) or w_{i-2} (a two-cycle: w_iters = w_i if
    iters - i is even, else w_{i-1}), bit for bit, and at `iters` steps at
    most. A step is a function of (w, zc) alone, so W equals
    `_lambertw_vec(q, iters)` bit for bit. Returns (W, steps per lane,
    int32); the steps are those the kernel's lanes take on the same q when
    they round alike (the kernel itself counts nothing). Where q < 1e-3 the
    series value is the result, and no step is taken."""
    qc, zc, w_branch, w = _lambertw_seed(q)
    w_prev = w
    out = w
    steps = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    active = ~(qc < 1e-3)
    for i in range(1, iters + 1):
        if not bool(active.any()):
            break
        w_next = _halley_step(w, zc)
        steps += active
        fixed = _bits(w_next) == _bits(w)
        cycle = (_bits(w_next) == _bits(w_prev)) & (i >= 2)
        done = active & (fixed | cycle)
        keep_next = fixed | ((iters - i) % 2 == 0)
        out = torch.where(done, torch.where(keep_next, w_next, w), out)
        active &= ~done
        w_prev = torch.where(active, w, w_prev)
        w = torch.where(active, w_next, w)
    out = torch.where(active, w, out)
    return torch.where(qc < 1e-3, w_branch, out), steps


def waterfill_gprime_ref(mu: Tensor, j: Tensor, rmin: Tensor,
                         B_total: Tensor) -> Tensor:
    """Plain PyTorch g'(mu): mu (C, M), j / rmin (C, N), B_total (C,) ->
    (C, M), in the inputs' dtype."""
    w = _lambertw_vec(mu[:, :, None] / j[:, None, :])
    floor = torch.finfo(mu.dtype).eps ** 2
    part = rmin[:, None, :] * _LN2 / torch.clamp_min(w + 1.0, floor)
    return part.sum(-1) - B_total[:, None]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("waterfill")
    for fn in (lib.waterfill_gprime_f32, lib.waterfill_gprime_f64):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.waterfill_error_string.argtypes = [ctypes.c_int]
    lib.waterfill_error_string.restype = ctypes.c_char_p
    return lib


def _check(mu: Tensor, j: Tensor, rmin: Tensor, B_total: Tensor):
    ts = (mu, j, rmin, B_total)
    if any(t.device.type != "cuda" or t.device != mu.device for t in ts):
        raise ValueError("waterfill_gprime: every tensor must be on one CUDA "
                         "device")
    if mu.dtype not in (torch.float32, torch.float64) \
            or any(t.dtype != mu.dtype for t in ts):
        raise TypeError("waterfill_gprime: tensors must share float32 or "
                        f"float64, got {[t.dtype for t in ts]}")
    if any(not t.is_contiguous() for t in ts) \
            or any(t.ndim != 2 for t in (mu, j, rmin)) or B_total.ndim != 1:
        raise ValueError("waterfill_gprime: mu, j, rmin must be contiguous "
                         "2-D and B_total contiguous 1-D")
    C, M = mu.shape
    N = j.shape[1]
    if j.shape != (C, N) or rmin.shape != (C, N) or B_total.shape != (C,):
        raise ValueError(
            f"waterfill_gprime: shapes mu {tuple(mu.shape)}, j "
            f"{tuple(j.shape)}, rmin {tuple(rmin.shape)}, B_total "
            f"{tuple(B_total.shape)} do not fit (C, M), (C, N), (C, N), (C,)")
    if not (0 < C <= 65535 and M > 0 and N > 0):
        raise ValueError(f"waterfill_gprime: need 0 < C <= 65535, M > 0, "
                         f"N > 0; got C={C}, M={M}, N={N}")


def waterfill_gprime(mu: Tensor, j: Tensor, rmin: Tensor,
                     B_total: Tensor) -> Tensor:
    """CUDA kernel: g'(mu) per cell and candidate multiplier, (C, M).

    One launch covers every cell. Each lane stops its Halley loop at the
    first iterate that repeats one of the two before it bit for bit
    (`lambertw_early_exit`), which gives the 24-step W exactly. The sum
    over devices runs in a fixed order (a shuffle butterfly per warp, the
    warps in order, then the blocks in index order), so equal inputs give
    bitwise equal sums on every run: the dual search picks its bracket from
    the sign of these sums. Lanes past N add exactly 0.
    """
    _check(mu, j, rmin, B_total)
    C, M = mu.shape
    N = j.shape[1]
    n_chunks = -(-N // BLOCK_N)
    partials = torch.empty((C, n_chunks, M), dtype=mu.dtype, device=mu.device)
    out = torch.empty((C, M), dtype=mu.dtype, device=mu.device)
    lib = _lib()
    fn = lib.waterfill_gprime_f32 if mu.dtype == torch.float32 \
        else lib.waterfill_gprime_f64
    with torch.cuda.device(mu.device):
        rc = fn(mu.data_ptr(), j.data_ptr(), rmin.data_ptr(),
                B_total.data_ptr(), partials.data_ptr(), out.data_ptr(),
                C, M, N, BLOCK_N,
                torch.cuda.current_stream(mu.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("waterfill_gprime: kernel launch failed: "
                           + lib.waterfill_error_string(rc).decode())
    waterfill_gprime.launches += 1
    return out


waterfill_gprime.launches = 0
