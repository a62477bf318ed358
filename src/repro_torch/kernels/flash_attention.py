"""Causal / sliding-window GQA attention (the serving prefill's attention).

Port of `repro/kernels/flash_attention.py` (the Pallas kernel
`flash_attention`). Two versions of one function live here:

  * `flash_attention_ref`: plain PyTorch, a masked softmax in float32 over
    the whole score matrix (as `repro/kernels/ref.py::flash_attention_ref`).
    The CPU path and the reference the CUDA kernel is held against.
  * `flash_attention`: the wrapper of the hand-written CUDA kernels in
    `csrc/flash_attention.cu` (built by `kernels.build`). CUDA tensors only;
    `body` picks one of its three bodies, and the wrapper counts its
    launches in `flash_attention.launches` and, per body, in
    `flash_attention.launches_by_body`.

Both take the JAX layout: q (B, H, S, hd), k (B, KV, T, hd), v (B, KV, T, vd)
with H % KV == 0 (query head h reads KV head h // (H // KV)), and return
(B, H, S, vd) in q's dtype. The key at position t is seen by the query at
position s when t <= s (causal) and t > s - window (a window is set). Any S
and T are taken: the kernel pads its tiles itself and masks padded keys,
causal or not. The kernel takes bfloat16 / float16 with hd % 16 == 0 and an
even vd <= 128 (its tensor-core bodies), float32 with hd, vd <= 256.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

Tensor = torch.Tensor

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
BODIES = ("wgmma", "mma", "simt")
# (q/k width, v width) of the wgmma body: the GQA heads and MLA's
# qk_nope + qk_rope = 96 with v 64
WGMMA_HEAD_DIMS = ((64, 64), (128, 128), (96, 64))


def body(q: Tensor, k: Tensor, v: Tensor) -> str:
    """The CUDA body that takes these inputs: "wgmma" (TMA and wgmma:
    16-bit, (hd, vd) in WGMMA_HEAD_DIMS, every batch/head/row stride a
    positive multiple of 16 bytes, every base 16-byte aligned), "mma"
    (mma.sync: every other 16-bit shape) or "simt" (float32). Reads only
    dtypes, shapes, strides and data pointers, so CPU tensors answer too."""
    if q.dtype == torch.float32:
        return "simt"
    tma = all(t.data_ptr() % 16 == 0
              and all(st > 0 and st * t.element_size() % 16 == 0
                      for st in t.stride()[:3]) for t in (q, k, v))
    dims = (q.shape[-1], v.shape[-1])
    return "wgmma" if dims in WGMMA_HEAD_DIMS and tma else "mma"


def _mask(S: int, T: int, causal: bool, window: Optional[int],
          device) -> Tensor:
    """(S, T) boolean: True where query s sees key t."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    return ok


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> Tensor:
    """Plain masked-softmax attention in float32 -> (B, H, S, vd), q.dtype."""
    H, S, hd = q.shape[1], q.shape[2], q.shape[3]
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5 if scale is None else scale
    kh = k.float().repeat_interleave(G, dim=1)
    vh = v.float().repeat_interleave(G, dim=1)
    s = torch.matmul(q.float(), kh.transpose(-1, -2)) * scale
    ok = _mask(S, T, causal, window, q.device)
    s = torch.where(ok, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, vh).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    tail = [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_fwd.argtypes = [ctypes.c_int] \
        + [ctypes.c_void_p] * 4 + tail
    # the wgmma entry also takes its blocks' tile counter after o
    lib.flash_attention_fwd_wgmma.argtypes = [ctypes.c_int] \
        + [ctypes.c_void_p] * 5 + tail
    for fn in (lib.flash_attention_fwd, lib.flash_attention_fwd_wgmma):
        fn.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: Tensor, k: Tensor, v: Tensor, window: Optional[int]):
    ts = (q, k, v)
    if any(t.device.type != "cuda" or t.device != q.device for t in ts):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError("flash_attention: q, k, v must share float32, "
                        f"bfloat16 or float16, got {[t.dtype for t in ts]}")
    if any(t.ndim != 4 or t.stride(-1) != 1 for t in ts):
        raise ValueError("flash_attention: q, k, v must be 4-D with a "
                         "contiguous last dimension")
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    if k.shape != (B, KV, T, hd) or v.shape[:3] != (B, KV, T) \
            or H % KV != 0:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         "(B,H,S,hd), (B,KV,T,hd), (B,KV,T,vd), H % KV == 0")
    if not (0 < hd <= 256 and 0 < v.shape[3] <= 256 and 0 < B <= 65535
            and 0 < H <= 65535 and S > 0 and T > 0):
        raise ValueError(f"flash_attention: need hd, vd <= 256, B, H <= 65535 "
                         f"and S, T > 0; got q {tuple(q.shape)}, v "
                         f"{tuple(v.shape)}")
    if q.dtype != torch.float32 and (hd % 16 or v.shape[3] % 2
                                     or v.shape[3] > 128):
        raise ValueError("flash_attention: 16-bit inputs need hd % 16 == 0 "
                         f"and an even vd <= 128; got hd {hd}, vd "
                         f"{v.shape[3]}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None) -> Tensor:
    """CUDA kernel: attention -> (B, H, S, vd), contiguous, in q's dtype.

    q, k, v may be strided views (a transpose of (B, S, H, hd) included) as
    long as the last dimension is contiguous. `body(q, k, v)` picks the
    kernel; its entry refuses what it does not take. Two launches on equal
    inputs give bitwise equal outputs."""
    _check(q, k, v, window)
    B, H, S, hd = q.shape
    KV, T, vd = k.shape[1], k.shape[2], v.shape[3]
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty((B, H, S, vd), dtype=q.dtype, device=q.device)
    which = body(q, k, v)
    lib = _lib()
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    entry = lib.flash_attention_fwd
    if which == "wgmma":
        # the persistent blocks take their tiles from this counter, held
        # here until the launch is on the stream
        tiles = torch.zeros(1, dtype=torch.int32, device=q.device)
        ptrs.append(tiles.data_ptr())
        entry = lib.flash_attention_fwd_wgmma
    with torch.cuda.device(q.device):
        rc = entry(
            _DTYPES[q.dtype], *ptrs, B, H, KV, S, T, hd, vd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(bool(causal)),
            -1 if window is None else int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention: {which} kernel launch failed: "
                           + lib.flash_error_string(rc).decode())
    flash_attention.launches += 1
    flash_attention.launches_by_body[which] += 1
    return out


def reset_launches():
    """Sets the total and every per-body launch count to 0."""
    flash_attention.launches = 0
    flash_attention.launches_by_body = dict.fromkeys(BODIES, 0)


reset_launches()
