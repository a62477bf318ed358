"""The port's SP2 dual sweep `waterfill_gprime` (its plain PyTorch version,
which the CPU runs) and `core.lambertw.lambertw0`, against the JAX
package's Pallas kernel body (interpret mode), its `ref` oracle and its
Lambert W, on the same numpy inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from repro.core.lambertw import lambertw0 as jlambertw0
from repro.kernels import ref as jref
from repro.kernels.waterfill import waterfill_gprime as jwaterfill

from repro_torch.core.lambertw import lambertw0
from repro_torch.kernels import ops
from repro_torch.kernels.waterfill import (_lambertw_vec,
                                           waterfill_gprime_ref)

B_TOTAL = 20e6


def inputs(n, seed, m=32):
    """Multipliers across the branch point and far above it, and device
    coefficients of the scale the SP2 dual sees (as tests/test_fleet.py)."""
    rng = np.random.default_rng(seed)
    j = np.abs(rng.normal(size=n)) * 1e-3 + 1e-5
    rmin = np.abs(rng.normal(size=n)) * 1e5
    return np.logspace(-8, 0, m), j, rmin


def port(mu, j, rmin, dtype=torch.float64, b_total=B_TOTAL):
    t = lambda x: torch.tensor(np.atleast_2d(x), dtype=dtype)
    return waterfill_gprime_ref(t(mu), t(j), t(rmin),
                                torch.tensor([b_total], dtype=dtype))[0]


def positive_part_scale(mu, j, rmin, g):
    """The f32 tolerance's scale: the larger of the positive sum
    S = g + B_total (every term is positive) and Sigma rmin ln2 (the sum at
    W + 1 = 1)."""
    return np.maximum(np.abs(g + B_TOTAL), np.sum(rmin) * np.log(2.0))


@pytest.mark.parametrize("n", [7, 768, 1000, 1500])
def test_plain_version_matches_the_kernel_body(n):
    """Same math as the Pallas body run in interpret mode, float64: only
    the order of the device sum differs (blocks of 256 there)."""
    mu, j, rmin = inputs(n, n)
    ref = np.asarray(jwaterfill(jnp.asarray(mu), jnp.asarray(j),
                                jnp.asarray(rmin), B_TOTAL, block_n=256,
                                interpret=True, dtype=jnp.float64))
    ours = port(mu, j, rmin).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("n", [7, 768, 1000, 1500])
def test_plain_version_meets_the_oracle_bound(n):
    """The acceptance bound of tests/test_fleet.py against the z-form
    oracle `kernels.ref.waterfill_gprime_ref`: <= 1e-5 relative."""
    mu, j, rmin = inputs(n, n + 1)
    ref = np.asarray(jref.waterfill_gprime_ref(
        jnp.asarray(mu), jnp.asarray(j), jnp.asarray(rmin), B_TOTAL))
    ours = port(mu, j, rmin).numpy()
    err = np.abs(ours - ref) / np.maximum(np.abs(ref), 1.0)
    assert err.max() <= 1e-5


@pytest.mark.parametrize("n", [7, 1500])
def test_plain_version_float32_matches_the_kernel_body(n):
    """float32 against the float32 Pallas body: both round every term in
    float32, so they agree to ~N ulps of the sum's scale (tol 1e-5)."""
    mu, j, rmin = inputs(n, n + 2)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    ref = np.asarray(jwaterfill(f32(mu), f32(j), f32(rmin), B_TOTAL,
                                block_n=256, interpret=True,
                                dtype=jnp.float32), dtype=np.float64)
    ours = port(mu, j, rmin, torch.float32).double().numpy()
    assert ours.dtype == np.float64
    scale = positive_part_scale(mu, j, rmin, ref)
    assert (np.abs(ours - ref) / scale).max() <= 1e-5


def test_batched_rows_equal_single_rows():
    """(C, M) from one call equals C single-cell calls bit for bit, and
    zero-rmin lanes (how the solver parks masked devices) add exactly 0."""
    rows = [inputs(64, s) for s in (1, 2, 3)]
    t = lambda k: torch.tensor(np.stack([r[k] for r in rows]))
    b_total = torch.tensor([1e6, 2e7, 5e7], dtype=torch.float64)
    out = waterfill_gprime_ref(t(0), t(1), t(2), b_total)
    for c, (mu, j, rmin) in enumerate(rows):
        one = port(mu, j, rmin, b_total=float(b_total[c]))
        assert torch.equal(out[c], one)
    mu, j, rmin = rows[0]
    padded = port(mu, np.concatenate([j, np.full(9, j.max())]),
                  np.concatenate([rmin, np.zeros(9)]))
    np.testing.assert_allclose(padded.numpy(), port(mu, j, rmin).numpy(),
                               rtol=1e-14, atol=0)


def test_ops_entry_dispatches_by_device():
    mu, j, rmin = inputs(16, 4)
    t = lambda x: torch.tensor(np.atleast_2d(x))
    b = torch.tensor([B_TOTAL], dtype=torch.float64)
    assert torch.equal(ops.waterfill_gprime(t(mu), t(j), t(rmin), b),
                       waterfill_gprime_ref(t(mu), t(j), t(rmin), b))
    meta = lambda x: t(x).to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.waterfill_gprime(meta(mu), meta(j), meta(rmin), b.to("meta"))


def test_ratio_form_lambert_w_is_stable_at_the_branch_point():
    """q = mu/j from 0 through the q < 1e-3 series cut-over and above: W
    solves w e^w = (q - 1)/e, W = -1 exactly at q = 0, and W + 1 stays
    positive for q > 0, where the z form would cancel to 0."""
    q = np.concatenate([[0.0, 1e-12, 1e-6, 9.99e-4, 1e-3, 1.01e-3],
                        np.logspace(-2, 30, 40)])
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        w = _lambertw_vec(torch.tensor(q, dtype=dtype)).double().numpy()
        z = (q - 1.0) / np.e
        assert w[0] == -1.0 and (w[1:] + 1.0 > 0).all()
        big = q >= 1e-3
        resid = np.abs(w * np.exp(w) - z) / np.maximum(np.abs(z), 1.0)
        assert resid[big].max() <= tol


@pytest.mark.parametrize("dtype, jdtype, rtol", [
    (torch.float64, jnp.float64, 1e-12), (torch.float32, jnp.float32, 5e-7)])
def test_lambertw0_matches(dtype, jdtype, rtol):
    z = np.concatenate([np.linspace(-0.3678, -1e-3, 50),
                        np.logspace(-6, 6, 50), [1e30, 1e33]])
    ours = lambertw0(torch.tensor(z, dtype=dtype)).numpy()
    ref = np.asarray(jlambertw0(jnp.asarray(z, jdtype)))
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=0)


def test_lambertw0_identity():
    """Mirror of tests/test_core_allocator.py::test_lambertw_identity."""
    z = np.concatenate([np.linspace(-0.36, 0.0, 50), np.logspace(-6, 6, 50)])
    w = lambertw0(torch.tensor(z)).numpy()
    np.testing.assert_allclose(w * np.exp(w), z, rtol=1e-9, atol=1e-12)
    assert (w >= -1.0).all()
