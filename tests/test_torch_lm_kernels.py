"""The port's attention and RWKV6 kernels' plain versions against the JAX
package's oracles (`repro.kernels.ref`) and, for one small shape each,
against its Pallas kernels run in interpret mode (`repro.kernels.ops`), on
the CPU. Inputs come from numpy with a fixed seed; float32 at 2e-5 and
bfloat16 at 2e-2 for attention (the tolerances of tests/test_kernels.py),
1e-4 on the output and the final state for RWKV6. The CUDA kernels
themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rwkv6_scan as rw


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def attn_inputs(B, H, KV, S, T, hd, vd=None, seed=0):
    rng = np.random.default_rng(seed)
    vd = hd if vd is None else vd
    return (rng.standard_normal((B, H, S, hd)).astype(np.float32) * 0.3,
            rng.standard_normal((B, KV, T, hd)).astype(np.float32) * 0.3,
            rng.standard_normal((B, KV, T, vd)).astype(np.float32))


def both(xs, dtype):
    """The same values as jnp and torch arrays of `dtype`."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(x).astype(jd) for x in xs],
            [torch.tensor(x).to(td) for x in xs])


def as_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B, H, KV, S, hd", [
    (1, 2, 2, 128, 64),      # MHA
    (2, 4, 2, 256, 64),      # GQA 2:1
    (1, 8, 1, 128, 128),     # MQA
])
@pytest.mark.parametrize("window", [None, 128])
def test_flash_plain_matches_reference(B, H, KV, S, hd, dtype, window):
    (qj, kj, vj), (qt, kt, vt) = both(attn_inputs(B, H, KV, S, S, hd), dtype)
    exp = jref.flash_attention_ref(qj, kj, vj, causal=True, window=window)
    out = tops.flash_attention(qt, kt, vt, causal=True, window=window)
    assert out.dtype == qt.dtype and out.shape == (B, H, S, hd)
    np.testing.assert_allclose(as_f32(out), as_f32(exp), **_tol(dtype))


@pytest.mark.parametrize("S, T, hd, vd, causal", [
    (128, 256, 64, 64, False),   # tests/test_kernels.py's non-causal case
    (77, 77, 32, 32, True),      # ragged S, not a multiple of any tile
    (70, 130, 96, 64, False),    # ragged T != S, vd != hd
])
def test_flash_plain_ragged_and_noncausal(S, T, hd, vd, causal):
    (qj, kj, vj), (qt, kt, vt) = both(attn_inputs(1, 3, 1, S, T, hd, vd),
                                      "float32")
    exp = jref.flash_attention_ref(qj, kj, vj, causal=causal)
    out = fa.flash_attention_ref(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=2e-5,
                               atol=2e-5)


def test_flash_plain_matches_pallas_interpret():
    """One small shape through the Pallas kernel body itself."""
    (qj, kj, vj), (qt, kt, vt) = both(attn_inputs(1, 4, 2, 128, 128, 64),
                                      "float32")
    exp = jops.flash_attention(qj, kj, vj, causal=True, window=64,
                               block_q=64, block_k=64)
    out = fa.flash_attention_ref(qt, kt, vt, causal=True, window=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=2e-5,
                               atol=2e-5)


def test_model_layout_transpose_matches_chunked_attn():
    """The model hands (B, S, H, hd) over transposed, as the reference's
    `_chunked_attn` takes it."""
    from repro.models.attention import _chunked_attn

    q, k, v = (x.transpose(0, 2, 1, 3) for x in
               attn_inputs(2, 4, 2, 96, 96, 32, seed=3))
    exp = _chunked_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, window=None, scale=32 ** -0.5, chunk=64)
    qt, kt, vt = (torch.tensor(x).transpose(1, 2) for x in (q, k, v))
    out = tops.flash_attention(qt, kt, vt, causal=True).transpose(1, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=2e-5,
                               atol=2e-5)


def rwkv_inputs(B, T, H, K, strong=False, seed=2):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, T, H, K)) * 0.5
    k = rng.standard_normal((B, T, H, K)) * 0.5
    v = rng.standard_normal((B, T, H, K))
    logw = np.full((B, T, H, K), -8.0) if strong \
        else -np.exp(rng.standard_normal((B, T, H, K)) * 0.5 - 0.5)
    u = rng.standard_normal((H, K)) * 0.3
    return tuple(x.astype(np.float32) for x in (r, k, v, logw, u))


@pytest.mark.parametrize("B, T, H, K, chunk, strong", [
    (1, 64, 2, 32, 32, False),     # tests/test_kernels.py's sweep
    (2, 128, 4, 64, 64, False),
    (1, 128, 2, 32, 64, True),     # log w = -8: near-total forgetting
    (2, 100, 3, 32, 32, False),    # ragged T: a padded last chunk
    (1, 37, 2, 16, 16, False),
])
def test_rwkv_plain_matches_reference(B, T, H, K, chunk, strong):
    xs = rwkv_inputs(B, T, H, K, strong)
    oj, sj = jref.rwkv6_ref(*(jnp.asarray(x) for x in xs))
    ot, st = tops.rwkv6_scan(*(torch.tensor(x) for x in xs), chunk=chunk)
    assert ot.shape == (B, T, H, K) and st.shape == (B, H, K, K)
    assert bool(torch.isfinite(ot).all()) and bool(torch.isfinite(st).all())
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4,
                               atol=1e-4)


def test_rwkv_plain_matches_pallas_interpret():
    xs = rwkv_inputs(1, 64, 2, 32)
    exp = jops.rwkv6_scan(*(jnp.asarray(x) for x in xs), chunk=32)
    out, _ = rw.rwkv6_scan_ref(*(torch.tensor(x) for x in xs), chunk=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=1e-4,
                               atol=1e-4)


def test_rwkv_ragged_tail_leaves_state_unchanged():
    """Padding lanes (r = k = v = 0, logw = 0) carry the state through:
    the state after T steps does not depend on the chunk length."""
    xs = [torch.tensor(x) for x in rwkv_inputs(1, 50, 2, 16)]
    _, s16 = rw.rwkv6_scan_ref(*xs, chunk=16)
    _, s64 = rw.rwkv6_scan_ref(*xs, chunk=64)
    torch.testing.assert_close(s16, s64, rtol=1e-5, atol=1e-5)


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the ops entries take the plain versions; the kernel
    wrappers themselves never do."""
    q, k, v = (torch.tensor(x) for x in attn_inputs(1, 2, 2, 16, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v)
    xs = [torch.tensor(x) for x in rwkv_inputs(1, 16, 2, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        rw.rwkv6_scan(*xs, chunk=16)
    from repro_torch.kernels import mamba_scan as ms

    m = [torch.ones((1, 8, 16)), -torch.ones((16, 8)), torch.ones((1, 8, 8)),
         torch.ones((1, 8, 8)), torch.ones((1, 8, 16))]
    with pytest.raises(ValueError, match="CUDA"):
        ms.mamba_scan(*m)
    launches = tops.launch_counts()
    tops.flash_attention(q, k, v)
    tops.rwkv6_scan(*xs, chunk=16)
    tops.mamba_scan(*m)
    assert tops.launch_counts() == launches
