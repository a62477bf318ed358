"""The port's Mamba scan, Mamba mixer and MoE layer against the JAX
package's, on the CPU, in float32.

- `kernels.mamba_scan.mamba_scan_ref` (the plain version the CUDA kernel is
  held against) against `repro.kernels.ref.mamba_scan_ref` and the Pallas
  kernel in interpret mode (`repro.kernels.ops.mamba_scan`), to 1e-5: both
  sides run the same sequential recurrence in float32, so only the order
  of the n-sum differs.
- `models.ssm.mamba` against `repro.models.ssm.mamba`, to 1e-4: the
  reference's prefill is a chunked associative scan, a different summation
  order from the port's sequential one.
- `models.moe.apply_moe` against `repro.models.moe.apply_moe`, to 1e-5 on
  the output and the aux loss, with and without dropped tokens.

Inputs come from numpy with fixed seeds; the reference's parameters are
handed over as numpy arrays. The CUDA kernel itself is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro.models import ssm as jssm

from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops as tops
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm

SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
LAYER_TOL = dict(rtol=1e-4, atol=1e-4)


def scan_inputs(B, T, D, N, seed=4, dt_max=None):
    """dt = softplus(z - 1) > 0 (or uniform up to dt_max), A < 0."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, D)) - 1)) \
        if dt_max is None else rng.uniform(0.01, dt_max, (B, T, D))
    A = -np.exp(rng.standard_normal((D, N)) * 0.3)
    if dt_max is not None:
        A = -np.broadcast_to(np.arange(1.0, N + 1), (D, N))   # a_log's A
    Bt = rng.standard_normal((B, T, N)) * 0.5
    Ct = rng.standard_normal((B, T, N)) * 0.5
    x = rng.standard_normal((B, T, D))
    return tuple(np.ascontiguousarray(a, np.float32)
                 for a in (dt, A, Bt, Ct, x))


@pytest.mark.parametrize("B, T, D, N, chunk, bd", [
    (1, 64, 128, 8, 32, 128),      # tests/test_kernels.py's sweep
    (2, 128, 256, 16, 64, 128),
])
def test_plain_scan_matches_both_references(B, T, D, N, chunk, bd):
    xs = scan_inputs(B, T, D, N)
    yr, hr = jref.mamba_scan_ref(*(jnp.asarray(a) for a in xs))
    yp = jops.mamba_scan(*(jnp.asarray(a) for a in xs), chunk=chunk,
                         block_d=bd)
    y, h = tops.mamba_scan(*(torch.tensor(a) for a in xs))
    assert y.shape == (B, T, D) and h.shape == (B, D, N)
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), **SCAN_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), **SCAN_TOL)


@pytest.mark.parametrize("B, T, D, N, dt_max", [
    (2, 37, 50, 16, None),     # ragged T and D: no chunk or block multiple
    (1, 100, 33, 8, None),
    (1, 1, 16, 16, None),      # one step
    (2, 64, 40, 16, 5.0),      # strong decay: dt A down to -80
])
def test_plain_scan_ragged_and_final_state(B, T, D, N, dt_max):
    xs = scan_inputs(B, T, D, N, seed=6, dt_max=dt_max)
    yr, hr = jref.mamba_scan_ref(*(jnp.asarray(a) for a in xs))
    y, h = ms.mamba_scan_ref(*(torch.tensor(a) for a in xs))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), **SCAN_TOL)


def test_plain_scan_takes_strided_halves():
    """Bt and Ct as the two halves of one (B, T, 2N) tensor, as the model
    passes them."""
    dt, A, Bt, Ct, x = scan_inputs(2, 40, 24, 8)
    bc = torch.tensor(np.concatenate([Bt, Ct], -1))
    y, h = ms.mamba_scan_ref(torch.tensor(dt), torch.tensor(A),
                             *bc.chunk(2, -1), torch.tensor(x))
    y2, h2 = ms.mamba_scan_ref(*(torch.tensor(a) for a in (dt, A, Bt, Ct,
                                                            x)))
    assert torch.equal(y, y2) and torch.equal(h, h2)


def load(module, tree):
    """`module` with every parameter replaced by the same-named numpy leaf
    of `tree`, in float32."""
    for name, p in module.named_parameters():
        p.data = torch.tensor(np.asarray(tree[name], np.float32))
    return module


def mamba_pair(d_model=32, d_inner=64, d_state=16, seed=1):
    pj = jssm.init_mamba(jax.random.PRNGKey(seed), d_model, d_inner, d_state,
                         4, dtype=jnp.float32)
    pt = tssm.Mamba(torch.Generator().manual_seed(0), d_model, d_inner,
                    d_state, 4, dtype=torch.float32)
    assert sorted(n for n, _ in pt.named_parameters()) == sorted(pj)
    return pj, load(pt, pj)


@pytest.mark.parametrize("d_state", [8, 16])
def test_mamba_prefill_and_cache_match_reference(d_state):
    """Prefill at S a multiple of the reference's chunk: output, conv tail
    and state."""
    pj, pt = mamba_pair(d_state=d_state)
    x = np.random.default_rng(2).standard_normal((2, 64, 32)).astype(
        np.float32)
    oj, cj = jssm.mamba(pj, jnp.asarray(x), mode="prefill",
                        cache=jssm.init_mamba_cache(2, 64, d_state, 4,
                                                    jnp.float32), chunk=32)
    ot, ct = tssm.mamba(pt, torch.tensor(x), mode="prefill",
                        cache=tssm.init_mamba_cache(2, 64, d_state, 4,
                                                    torch.float32))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **LAYER_TOL)
    np.testing.assert_allclose(ct.conv.numpy(), np.asarray(cj.conv),
                               **LAYER_TOL)
    np.testing.assert_allclose(ct.h.numpy(), np.asarray(cj.h), **LAYER_TOL)
    assert ct.conv.dtype == torch.float32 and ct.h.dtype == torch.float32


def test_mamba_train_mode_at_ragged_length():
    """The reference pads a ragged S to its chunk; the port needs no pad."""
    pj, pt = mamba_pair()
    x = np.random.default_rng(3).standard_normal((2, 45, 32)).astype(
        np.float32)
    oj, cj = jssm.mamba(pj, jnp.asarray(x), mode="train", chunk=32)
    ot, ct = tssm.mamba(pt, torch.tensor(x), mode="train")
    assert cj is None and ct is None
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **LAYER_TOL)


def test_mamba_decode_steps_match_reference():
    pj, pt = mamba_pair()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 32)).astype(np.float32)
    _, cj = jssm.mamba(pj, jnp.asarray(x), mode="prefill",
                       cache=jssm.init_mamba_cache(2, 64, 16, 4, jnp.float32),
                       chunk=32)
    _, ct = tssm.mamba(pt, torch.tensor(x), mode="prefill",
                       cache=tssm.init_mamba_cache(2, 64, 16, 4,
                                                   torch.float32))
    for _ in range(3):
        xd = rng.standard_normal((2, 1, 32)).astype(np.float32)
        oj, cj = jssm.mamba(pj, jnp.asarray(xd), mode="decode", cache=cj)
        ot, ct = tssm.mamba(pt, torch.tensor(xd), mode="decode", cache=ct)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **LAYER_TOL)
        np.testing.assert_allclose(ct.h.numpy(), np.asarray(cj.h),
                                   **LAYER_TOL)
        np.testing.assert_allclose(ct.conv.numpy(), np.asarray(cj.conv),
                                   **LAYER_TOL)


def test_mamba_prefill_hands_over_at_any_length():
    """Prefill of S tokens then one decode step equals the last position of
    a prefill of S + 1 tokens, at an S that is no chunk multiple."""
    _, pt = mamba_pair()
    x = torch.tensor(np.random.default_rng(5).standard_normal(
        (2, 38, 32)).astype(np.float32))
    cache = tssm.init_mamba_cache(2, 64, 16, 4, torch.float32)
    _, cache = tssm.mamba(pt, x[:, :37], mode="prefill", cache=cache)
    dec, _ = tssm.mamba(pt, x[:, 37:], mode="decode", cache=cache)
    full, _ = tssm.mamba(pt, x, mode="train")
    torch.testing.assert_close(dec[:, 0], full[:, -1], rtol=1e-5, atol=1e-5)


def moe_pair(d_model=32, d_ff=64, n_experts=4, seed=2):
    pj = jmoe.init_moe(jax.random.PRNGKey(seed), d_model, d_ff, n_experts,
                       jnp.float32)
    pt = tmoe.MoE(torch.Generator().manual_seed(0), d_model, d_ff, n_experts,
                  torch.float32)
    assert sorted(n for n, _ in pt.named_parameters()) == sorted(pj)
    return pj, load(pt, pj)


def dropped(gates, top_k, capacity_factor):
    """(B, S, E) mask of assignments past the capacity, the reference's
    sequence-order rule in numpy."""
    B, S, E = gates.shape
    cap = max(int(top_k * S * capacity_factor / E), 1)
    assigned = gates > 0
    return assigned & (np.cumsum(assigned, axis=1) - 1 >= cap)


@pytest.mark.parametrize("E, top_k, cf, S, want_drops", [
    (4, 2, 2.0, 24, False),     # cap 24 = S: nothing can drop
    (4, 2, 1.25, 24, True),     # mixtral's factor, cap 15: some drop
    (4, 2, 0.5, 24, True),      # cap 6: many drop
    (8, 4, 0.3, 40, True),      # dbrx-like top 4
    (4, 2, 1.25, 1, False),     # decode: S = 1, cap 1
])
def test_apply_moe_matches_reference(E, top_k, cf, S, want_drops):
    pj, pt = moe_pair(n_experts=E)
    x = np.random.default_rng(6).standard_normal((2, S, 32)).astype(
        np.float32)
    oj, aj = jmoe.apply_moe(pj, jnp.asarray(x), top_k, cf)
    ot, at = tmoe.apply_moe(pt, torch.tensor(x), top_k, cf)
    assert ot.shape == x.shape and ot.dtype == torch.float32
    assert at.dtype == torch.float32 and at.shape == ()
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)
    # the same routing, so the same assignments dropped
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), pj["router"])
    gj, _ = jmoe._top_k_gates(logits, top_k)
    gt, idx, _ = tmoe._top_k_gates(torch.tensor(np.asarray(logits)), top_k)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-7)
    assert bool((gt.gather(-1, idx) > 0).all())
    drops = dropped(np.asarray(gj), top_k, cf)
    assert bool(drops.any()) == want_drops
    # a token whose every assignment was dropped comes out zero in both
    gone = (drops.sum(-1) == top_k)
    assert np.array_equal(np.abs(ot.numpy()).sum(-1) == 0, gone)
    assert np.array_equal(np.abs(np.asarray(oj)).sum(-1) == 0, gone)


def test_apply_moe_is_bitwise_repeatable_in_bf16():
    """The combine gathers per token (no scatter-add), so two runs give the
    same bits."""
    _, pt = moe_pair()
    pt = pt.to(torch.bfloat16)
    pt.router.data = pt.router.data.float()
    x = torch.tensor(np.random.default_rng(7).standard_normal(
        (2, 24, 32)).astype(np.float32)).to(torch.bfloat16)
    a, _ = tmoe.apply_moe(pt, x, 2, 0.5)
    b, _ = tmoe.apply_moe(pt, x, 2, 0.5)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
