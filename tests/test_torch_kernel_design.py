"""The design of the port's Hopper kernels, checked on the CPU.

* `flash_attention.body`, the function that picks the CUDA body for the
  given inputs, on CPU tensors (it reads only dtypes, shapes, strides and
  data pointers; no kernel runs): the wgmma/TMA body for the served
  prefills, contiguous or as the model's (B, S, H, hd).transpose(1, 2)
  views; mma.sync for the other 16-bit shapes and for views off 16 bytes;
  the SIMT body for float32.
* The two-pass decomposition of `csrc/rwkv6_scan.cu`, rendered in plain
  torch here in float64 (a state pass that keeps the state entering each
  chunk, then an output pass per chunk that builds A from pairwise
  exponentials inside 16-row sub-blocks and from three factors across
  them), against the JAX package's sequential recurrence
  `repro.kernels.ref.rwkv6_ref` (which computes in float32: 1e-5 relative
  and absolute) and against the same recurrence in float64 (the
  decomposition is exact: 1e-10).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ref as jref

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa

SERVED = ("internlm2-20b", "jamba-1.5-large-398b")


def attn_tensors(B, H, KV, S, hd, vd=None, dtype=torch.bfloat16,
                 model_layout=False):
    """q, k, v of the given shapes, contiguous or as transposes of
    (B, S, heads, hd) tensors (the model's layout)."""
    vd = hd if vd is None else vd
    if model_layout:
        return (torch.zeros((B, S, H, hd), dtype=dtype).transpose(1, 2),
                torch.zeros((B, S, KV, hd), dtype=dtype).transpose(1, 2),
                torch.zeros((B, S, KV, vd), dtype=dtype).transpose(1, 2))
    return (torch.zeros((B, H, S, hd), dtype=dtype),
            torch.zeros((B, KV, S, hd), dtype=dtype),
            torch.zeros((B, KV, S, vd), dtype=dtype))


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("model_layout", [False, True])
def test_served_prefills_take_the_wgmma_body(arch, model_layout):
    cfg = get_config(arch)
    vd = cfg.v_head_dim or cfg.head_dim
    q, k, v = attn_tensors(2, cfg.n_heads, cfg.kv_heads, 64, cfg.head_dim,
                           vd, model_layout=model_layout)
    assert q.is_contiguous() != model_layout
    assert fa.body(q, k, v) == "wgmma"
    assert fa.body(q.half(), k.half(), v.half()) == "wgmma"


@pytest.mark.parametrize("hd, vd", [(32, 32), (96, 96), (96, 64), (128, 64),
                                    (64, 128), (16, 16)])
def test_other_16_bit_shapes_take_mma_sync(hd, vd):
    q, k, v = attn_tensors(1, 4, 2, 32, hd, vd)
    assert fa.body(q, k, v) == "mma"
    q, k, v = attn_tensors(1, 4, 2, 32, hd, vd, model_layout=True)
    assert fa.body(q, k, v) == "mma"


def test_views_off_16_bytes_take_mma_sync():
    # rows of 136 elements (272 bytes): a base 0, 2 or 4 bytes in
    q, k, v = (torch.zeros((1, 2, 32, 136), dtype=torch.bfloat16)
               for _ in range(3))
    assert fa.body(q[..., :128], k[..., :128], v[..., :128]) == "wgmma"
    assert fa.body(q[..., 1:129], k[..., :128], v[..., :128]) == "mma"
    assert fa.body(q[..., :128], k[..., :128], v[..., 2:130]) == "mma"
    # rows of 66 elements: 132-byte strides, the base aligned
    p = torch.zeros((1, 2, 32, 66), dtype=torch.bfloat16)
    q64, k64, v64 = attn_tensors(1, 2, 2, 32, 64)
    assert fa.body(p[..., :64], k64, v64) == "mma"
    assert fa.body(q64, k64, p[..., :64]) == "mma"
    assert fa.body(q64, k64, v64) == "wgmma"


@pytest.mark.parametrize("hd, vd", [(128, 128), (64, 64), (96, 64), (24, 24)])
def test_float32_takes_the_simt_body(hd, vd):
    q, k, v = attn_tensors(1, 4, 2, 32, hd, vd, dtype=torch.float32)
    assert fa.body(q, k, v) == "simt"


def test_every_body_has_a_launch_count():
    fa.reset_launches()
    assert fa.flash_attention.launches == 0
    assert fa.flash_attention.launches_by_body == dict.fromkeys(fa.BODIES, 0)


# ---------------------------------------------------------------------------
# rwkv6_scan: the two passes
# ---------------------------------------------------------------------------

SUB = 16  # rows of a sub-block of the output pass


def _chunks(x, chunk):
    B, T = x.shape[:2]
    pad = (-T) % chunk
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    return [x[:, c0:c0 + chunk] for c0 in range(0, T + pad, chunk)]


def state_pass(k, v, logw, chunk):
    """(the state entering each chunk, the final state): per chunk
    S <- exp(clw_L) S + (exp(clw_L - clw) o k)^T v, clw summed in order."""
    B, T, H, K = k.shape
    S = torch.zeros((B, H, K, K), dtype=k.dtype)
    entering = []
    for kc, vc, wc in zip(*(_chunks(x, chunk) for x in (k, v, logw))):
        entering.append(S)
        clw = wc.cumsum(1)
        kd = torch.exp(clw[:, -1:] - clw) * kc
        S = torch.exp(clw[:, -1])[..., None] * S \
            + torch.einsum("blhk,blhv->bhkv", kd, vc)
    return entering, S


def pair_factors(clw, clwp):
    """(B, L, L, H, K) exp(clw'_t - clw_tau) for tau < t (0 elsewhere):
    pairwise inside a sub-block; across sub-blocks I > J, the product of
    exp(clw'_t - clw_{e_{I-1}}), exp(clw_{e_{I-1}} - clw_{e_J}) and
    exp(clw_{e_J} - clw_tau), e_X = 16 X + 15 the sub-blocks' last rows."""
    L = clw.shape[1]
    fac = torch.zeros((clw.shape[0], L, L) + clw.shape[2:], dtype=clw.dtype)
    for t in range(L):
        for tau in range(t):
            I, J = t // SUB, tau // SUB
            if I == J:
                fac[:, t, tau] = torch.exp(clwp[:, t] - clw[:, tau])
            else:
                eI, eJ = SUB * I - 1, SUB * J + SUB - 1
                fac[:, t, tau] = (torch.exp(clwp[:, t] - clw[:, eI])
                                  * torch.exp(clw[:, eI] - clw[:, eJ])
                                  * torch.exp(clw[:, eJ] - clw[:, tau]))
    return fac


def output_pass(r, k, v, logw, u, entering, chunk):
    """o chunk by chunk from the state entering it, independent chunks:
    (r o exp(clw')) S + A v + (r u k) v."""
    outs = []
    for rc, kc, vc, wc, S in zip(*(_chunks(x, chunk) for x in (r, k, v, logw)),
                                 entering):
        clw = wc.cumsum(1)
        clwp = clw - wc
        o = torch.einsum("blhk,bhkv->blhv", rc * torch.exp(clwp), S)
        att = torch.einsum("blhk,blthk,bthk->blth", rc,
                           pair_factors(clw, clwp), kc)
        o = o + torch.einsum("blth,bthv->blhv", att, vc)
        o = o + (rc * u * kc).sum(-1, keepdim=True) * vc
        outs.append(o)
    return torch.cat(outs, 1)[:, :r.shape[1]]


def rwkv_inputs(B, T, H, K, strong=False, seed=2):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, T, H, K)) * 0.5
    k = rng.standard_normal((B, T, H, K)) * 0.5
    v = rng.standard_normal((B, T, H, K))
    logw = np.full((B, T, H, K), -8.0) if strong \
        else -np.exp(rng.standard_normal((B, T, H, K)) * 0.5 - 0.5)
    u = rng.standard_normal((H, K)) * 0.3
    return r, k, v, logw, u


def recurrence(r, k, v, logw, u):
    """The definitional recurrence, step by step, in the inputs' dtype:
    o_t = r_t . (S + diag(u) k_t v_t^T), S <- diag(w_t) S + k_t v_t^T."""
    B, T, H, K = r.shape
    S = torch.zeros((B, H, K, K), dtype=r.dtype)
    outs = []
    for t in range(T):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, S)
                    + (rt * u * kt).sum(-1, keepdim=True) * vt)
        S = torch.exp(logw[:, t])[..., None] * S \
            + kt[..., :, None] * vt[..., None, :]
    return torch.stack(outs, 1), S


@pytest.mark.parametrize("B, T, H, K, chunk, strong", [
    (1, 64, 2, 16, 16, False),
    (2, 96, 2, 32, 32, False),
    (1, 128, 2, 16, 64, False),
    (1, 128, 2, 16, 64, True),      # log w = -8: near-total forgetting
    (1, 100, 2, 16, 32, False),     # ragged T: a padded last chunk
    (2, 77, 1, 32, 64, False),
])
def test_two_pass_decomposition_matches_reference(B, T, H, K, chunk, strong):
    xs = rwkv_inputs(B, T, H, K, strong)
    r, k, v, logw, u = (torch.tensor(x, dtype=torch.float64) for x in xs)
    entering, S = state_pass(k, v, logw, chunk)
    o = output_pass(r, k, v, logw, u, entering, chunk)
    assert len(entering) == -(-T // chunk)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(S).all())
    oj, sj = jref.rwkv6_ref(*(jnp.asarray(x) for x in xs))
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(S.numpy(), np.asarray(sj), rtol=1e-5,
                               atol=1e-5)
    o64, s64 = recurrence(r, k, v, logw, u)
    torch.testing.assert_close(o, o64, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(S, s64, rtol=1e-10, atol=1e-10)


def test_pair_factors_never_exceed_one():
    """Every factor's exponent is <= 0, also at log w = -8 over 64 rows (up
    to the rounding of clw' = clw - logw, as in the plain version)."""
    for strong in (False, True):
        *_, logw, _ = rwkv_inputs(1, 64, 1, 16, strong)
        wc = torch.tensor(logw, dtype=torch.float64)
        clw = wc.cumsum(1)
        fac = pair_factors(clw, clw - wc)
        assert bool((fac <= 1.0 + 1e-12).all())
        assert bool(torch.isfinite(fac).all())
