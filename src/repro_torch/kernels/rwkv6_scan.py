"""RWKV6 (Finch) chunked WKV recurrence (the rwkv prefill's time mix).

Port of `repro/kernels/rwkv6_scan.py` (the Pallas kernel `rwkv6_scan`).
Two versions of one function live here:

  * `rwkv6_scan_ref`: plain PyTorch, the chunked parallel form of
    `repro/models/ssm.py::_wkv_chunk` (log-space pairwise decays
    exp(clw'_t - clw_tau) <= 1, the u bonus on the diagonal, the (K, V)
    state carried across chunks). The CPU path and the reference the CUDA
    kernel is held against.
  * `rwkv6_scan`: the wrapper of the hand-written CUDA kernels in
    `csrc/rwkv6_scan.cu` (built by `kernels.build`): a state pass over the
    chunks in order, then an output pass with one block per chunk. CUDA
    tensors only; it counts its calls in `rwkv6_scan.launches` and each
    pass's kernel launches in `rwkv6_scan.launches_by_pass`.

Both take r, k, v, logw (B, T, H, K) and u (H, K), start from a zero state
and return (o (B, T, H, K), S_end (B, H, K, K)) in float32: unlike the
Pallas kernel they also return the final state, which the decode cache
needs. T need not be a multiple of the chunk: the tail is padded with
r = k = v = 0 and logw = 0, which leaves the state unchanged.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

Tensor = torch.Tensor

CHUNKS = (16, 32, 64)   # chunk lengths the kernel is built for
HEAD_DIMS = (16, 32, 64)


def rwkv6_scan_ref(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
                   *, chunk: int = 64) -> Tuple[Tensor, Tensor]:
    """Plain chunked WKV6 -> (o (B, T, H, K), S_end (B, H, K, K)), float32."""
    B, T, H, K = r.shape
    pad = (-T) % chunk
    r, k, v, logw = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
                     for t in (r, k, v, logw))
    u = u.float()
    S = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    idx = torch.arange(chunk, device=r.device)
    tri = (idx[:, None] > idx[None, :])[None, :, :, None, None]
    outs = []
    for c0 in range(0, T + pad, chunk):
        rr, kk, vv, ww = (t[:, c0:c0 + chunk] for t in (r, k, v, logw))
        clw = ww.cumsum(1)                                  # inclusive
        clw_prev = clw - ww                                 # exclusive
        o = torch.einsum("blhk,bhkv->blhv", rr * torch.exp(clw_prev), S)
        decay = clw_prev[:, :, None] - clw[:, None, :]      # (B, t, tau, H, K)
        fac = torch.exp(torch.where(tri, decay,
                                    torch.full((), -torch.inf,
                                               device=r.device)))
        att = torch.einsum("blhk,blthk,bthk->blth", rr, fac, kk)
        o = o + torch.einsum("blth,bthv->blhv", att, vv)
        o = o + (rr * u * kk).sum(-1, keepdim=True) * vv
        outs.append(o)
        S = torch.exp(clw[:, -1])[..., None] * S + torch.einsum(
            "blhk,blhv->bhkv", torch.exp(clw[:, -1:] - clw) * kk, vv)
    return torch.cat(outs, 1)[:, :T], S


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("rwkv6_scan")
    fn = lib.rwkv6_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rwkv6_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_error_string.restype = ctypes.c_char_p
    return lib


def _check(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
           chunk: int):
    ts = (r, k, v, logw, u)
    if any(t.device.type != "cuda" or t.device != r.device for t in ts):
        raise ValueError("rwkv6_scan: every tensor must be on one CUDA "
                         "device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"rwkv6_scan: tensors must be float32, got "
                        f"{[t.dtype for t in ts]}")
    if r.ndim != 4 or any(t.shape != r.shape or t.stride(-1) != 1
                          for t in (r, k, v, logw)):
        raise ValueError("rwkv6_scan: r, k, v, logw must share one 4-D shape "
                         "(B, T, H, K) with a contiguous last dimension")
    B, T, H, K = r.shape
    if u.shape != (H, K) or not u.is_contiguous():
        raise ValueError(f"rwkv6_scan: u must be contiguous (H, K) = "
                         f"{(H, K)}, got {tuple(u.shape)}")
    if chunk not in CHUNKS or K not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: the kernel takes chunk in {CHUNKS} and "
                         f"K in {HEAD_DIMS}, got chunk={chunk}, K={K}")
    if not (0 < B <= 65535 and T > 0 and 0 < H <= 65535):
        raise ValueError(f"rwkv6_scan: need 0 < B, H <= 65535 and T > 0; got "
                         f"{tuple(r.shape)}")


PASSES = {"state": 1, "output": 2}


def launch(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor, o: Tensor,
           S: Tensor, states: Tensor, *, chunk: int,
           passes=("state", "output")) -> None:
    """Launches the named passes, in order, on the current stream, counting
    each in `rwkv6_scan.launches_by_pass`: "state" writes `states` (the
    state entering every chunk but the first, (B, H, n_chunks - 1, K, K))
    and the final state S; "output" reads `states` and writes o. The
    wrapper `rwkv6_scan` runs both; one pass alone is for timing it."""
    B, T, H, K = r.shape
    strides = (ctypes.c_longlong * 12)(*(s for t in (r, k, v, logw)
                                         for s in t.stride()[:3]))
    lib = _lib()
    with torch.cuda.device(r.device):
        rc = lib.rwkv6_scan_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), o.data_ptr(), S.data_ptr(), states.data_ptr(), B,
            T, H, K, chunk, ctypes.addressof(strides),
            sum(PASSES[p] for p in passes),
            torch.cuda.current_stream(r.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("rwkv6_scan: kernel launch failed: "
                           + lib.rwkv6_error_string(rc).decode())
    for p in passes:
        rwkv6_scan.launches_by_pass[p] += 1


def buffers(r: Tensor, chunk: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Uninitialised (o, S_end, states) for `launch`, on r's device."""
    B, T, H, K = r.shape
    n_chunks = -(-T // chunk)
    return (torch.empty((B, T, H, K), dtype=torch.float32, device=r.device),
            torch.empty((B, H, K, K), dtype=torch.float32, device=r.device),
            torch.empty((B, H, n_chunks - 1, K, K), dtype=torch.float32,
                        device=r.device))


def rwkv6_scan(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor, *,
               chunk: int = 64) -> Tuple[Tensor, Tensor]:
    """CUDA kernels: chunked WKV6 -> (o (B, T, H, K), S_end (B, H, K, K)).

    r, k, v, logw may be strided views with a contiguous last dimension.
    The state pass (one block per (h, b)) walks the chunks in order and
    keeps the state entering each in a scratch buffer; the output pass (one
    block per (chunk, h, b)) reads it. Two calls on
    equal inputs give bitwise equal outputs."""
    _check(r, k, v, logw, u, chunk)
    o, S, states = buffers(r, chunk)
    launch(r, k, v, logw, u, o, S, states, chunk=chunk)
    rwkv6_scan.launches += 1
    return o, S


def reset_launches():
    """Sets the call count and both passes' launch counts to 0."""
    rwkv6_scan.launches = 0
    rwkv6_scan.launches_by_pass = dict.fromkeys(PASSES, 0)


reset_launches()
