"""Mamba selective scan (the mamba prefill's state-space recurrence).

Port of `repro/kernels/mamba_scan.py` (the Pallas kernel `mamba_scan`).
Two versions of one function live here:

  * `mamba_scan_ref`: plain PyTorch, the sequential recurrence of
    `repro/kernels/ref.py::mamba_scan_ref`. The CPU path and the reference
    the CUDA kernel is held against.
  * `mamba_scan`: the wrapper of the hand-written CUDA kernel in
    `csrc/mamba_scan.cu` (built by `kernels.build`). CUDA tensors only; it
    counts its launches in `mamba_scan.launches`.

Both take dt, x (B, T, D), A (D, N) and Bt, Ct (B, T, N), start from a zero
state and return (y (B, T, D), h_end (B, D, N)) in float32:
    h_t = exp(dt_t A) * h_{t-1} + dt_t B_t x_t,   y_t = h_t . C_t.
Unlike the Pallas kernel they also return the final state, which the decode
cache needs, and take any T >= 1 and any D (no chunk or block multiples).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

Tensor = torch.Tensor

STATE_SIZES = (8, 16)   # N the kernel is built for


def mamba_scan_ref(dt: Tensor, A: Tensor, Bt: Tensor, Ct: Tensor,
                   x: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain sequential scan -> (y (B, T, D), h_end (B, D, N)), float32."""
    dt, Bt, Ct, x, A = (t.float() for t in (dt, Bt, Ct, x, A))
    Bsz, T, D = x.shape
    h = torch.zeros((Bsz, D, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(T):
        dtt = dt[:, t, :, None]
        h = torch.exp(dtt * A) * h + dtt * Bt[:, t, None, :] \
            * x[:, t, :, None]
        ys.append(torch.einsum("bdn,bn->bd", h, Ct[:, t]))
    return torch.stack(ys, 1), h


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("mamba_scan")
    fn = lib.mamba_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mamba_error_string.argtypes = [ctypes.c_int]
    lib.mamba_error_string.restype = ctypes.c_char_p
    return lib


def _check(dt: Tensor, A: Tensor, Bt: Tensor, Ct: Tensor, x: Tensor):
    ts = (dt, A, Bt, Ct, x)
    if any(t.device.type != "cuda" or t.device != x.device for t in ts):
        raise ValueError("mamba_scan: every tensor must be on one CUDA "
                         "device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"mamba_scan: tensors must be float32, got "
                        f"{[t.dtype for t in ts]}")
    if x.ndim != 3 or dt.shape != x.shape or any(
            t.stride(-1) != 1 for t in (dt, x, Bt, Ct)):
        raise ValueError("mamba_scan: dt and x must share one 3-D shape "
                         "(B, T, D), and dt, x, Bt, Ct need a contiguous "
                         "last dimension")
    B, T, D = x.shape
    if A.ndim != 2 or A.shape[0] != D or not A.is_contiguous():
        raise ValueError(f"mamba_scan: A must be contiguous (D, N) with "
                         f"D = {D}, got {tuple(A.shape)}")
    N = A.shape[1]
    if Bt.shape != (B, T, N) or Ct.shape != (B, T, N):
        raise ValueError(f"mamba_scan: Bt and Ct must be (B, T, N) = "
                         f"{(B, T, N)}, got {tuple(Bt.shape)}, "
                         f"{tuple(Ct.shape)}")
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan: the kernel takes N in {STATE_SIZES}, "
                         f"got N={N}")
    if not (0 < B <= 65535 and T > 0 and D > 0):
        raise ValueError(f"mamba_scan: need 0 < B <= 65535, T, D > 0; got "
                         f"{tuple(x.shape)}")


def mamba_scan(dt: Tensor, A: Tensor, Bt: Tensor, Ct: Tensor,
               x: Tensor) -> Tuple[Tensor, Tensor]:
    """CUDA kernel: selective scan -> (y (B, T, D), h_end (B, D, N)).

    dt, x, Bt, Ct may be strided views with a contiguous last dimension.
    One thread per (b, d) channel walks the time steps with its N states in
    registers and sums y over n from 0 up, a fixed order, so two launches
    on equal inputs give bitwise equal outputs."""
    _check(dt, A, Bt, Ct, x)
    B, T, D = x.shape
    N = A.shape[1]
    y = torch.empty((B, T, D), dtype=torch.float32, device=x.device)
    h_end = torch.empty((B, D, N), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 8)(*(s for t in (dt, x, Bt, Ct)
                                        for s in t.stride()[:2]))
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.mamba_scan_fwd(
            dt.data_ptr(), A.data_ptr(), Bt.data_ptr(), Ct.data_ptr(),
            x.data_ptr(), y.data_ptr(), h_end.data_ptr(), B, T, D, N,
            ctypes.addressof(strides),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("mamba_scan: kernel launch failed: "
                           + lib.mamba_error_string(rc).decode())
    mamba_scan.launches += 1
    return y, h_end


mamba_scan.launches = 0
