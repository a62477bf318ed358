"""The port's SP1 dual sweep (`repro_torch.kernels.sp1_sweep`) against the
JAX package's Pallas kernel (interpret mode) and its jnp reference.

The plain PyTorch version is what runs on the CPU; the CUDA kernel is held
against it in `test_torch_cuda.py`, where there is a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from repro.core.accuracy import default_accuracy
from repro.core.types import DEFAULTS
from repro.kernels.ref import sp1_lambda_sum_ref
from repro.kernels.sp1_sweep import N_CONSTS
from repro.kernels.sp1_sweep import sp1_lambda_sum as pallas_sum

from repro_torch.kernels import ops, sp1_sweep

# one compile per shape instead of one per op
jax_ref = jax.jit(sp1_lambda_sum_ref)


def _sweep_inputs(seed=5, n=1000, w=(0.5, 0.5, 1.0), points=24):
    """numpy (T_grid (M,), q (N,), tt (N,), consts (8,)) for one cell with
    the paper's §VII-A parameters at the equal-split start (B = 400 kHz per
    device, p = pmax), drawn from `seed`."""
    rng = np.random.default_rng(seed)
    dist_km = np.maximum(np.hypot(*rng.uniform(-250.0, 250.0, (2, n))),
                         1.0) / 1000.0
    sigma = DEFAULTS["shadowing_db"] * np.log(10.0) / 10.0
    gain = 10.0 ** (-(128.1 + 37.6 * np.log10(dist_km)) / 10.0) \
        * np.exp(sigma ** 2 / 2.0)
    B, p_max = 20e6 / 50, DEFAULTS["p_max"]
    tt = DEFAULTS["upload_bits"] / (
        B * np.log2(1.0 + gain * p_max / (DEFAULTS["noise_psd"] * B)))
    q = DEFAULTS["local_iters"] / DEFAULTS["s_standard"] ** 2 \
        * rng.uniform(1e4, 3e4, n) * DEFAULTS["samples_per_device"]
    w1, w2, rho = (x / (w[0] + w[1]) for x in w)
    rg, f_max = DEFAULTS["global_rounds"], DEFAULTS["f_max"]
    k3 = 2.0 * w1 * rg * DEFAULTS["kappa"]
    lam_hi = max(k3 * f_max ** 3, w2 * rg, 1.0) * 1e4
    consts = np.zeros(N_CONSTS)
    consts[:7] = [k3, rho * default_accuracy().slope, DEFAULTS["f_min"],
                  f_max, DEFAULTS["resolutions"][0],
                  DEFAULTS["resolutions"][-1], lam_hi]
    T_grid = np.geomspace(tt.max() * 1.01, 1e4, points)
    return T_grid, q, tt, consts


def _port_sum(T_grid, q, tt, consts, dtype=torch.float64):
    """Single-cell call of the port's plain version (C = 1)."""
    t = [torch.tensor(x, dtype=dtype)[None] for x in (T_grid, q, tt, consts)]
    return sp1_sweep.sp1_lambda_sum_ref(*t)[0].numpy()


@pytest.mark.parametrize("N", [5, 1000, 1500])
def test_plain_sum_matches_pallas_kernel_f64(N):
    T_grid, q, tt, consts = _sweep_inputs(n=N)
    ours = _port_sum(T_grid, q, tt, consts)
    pallas = pallas_sum(*(jnp.asarray(x) for x in (T_grid, q, tt, consts)),
                        block_n=1024, interpret=True, dtype=jnp.float64)
    ref = jax_ref(*(jnp.asarray(x) for x in (T_grid, q, tt, consts)))
    np.testing.assert_allclose(ours, np.asarray(pallas), rtol=1e-12)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-12)


@pytest.mark.parametrize("N", [5, 1000, 1500])
def test_plain_sum_matches_reference_f32(N):
    T_grid, q, tt, consts = (x.astype(np.float32)
                             for x in _sweep_inputs(n=N))
    ours = _port_sum(T_grid, q, tt, consts, dtype=torch.float32)
    assert ours.dtype == np.float32
    ref = jax_ref(*(jnp.asarray(x) for x in (T_grid, q, tt, consts)))
    assert np.asarray(ref).dtype == np.float32
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-5)


def test_batched_rows_equal_single_cell_calls():
    """The (C, M) form is C independent cells: row c equals a C = 1 call
    on cell c's inputs (different systems, weights and grids per cell)."""
    cells = [_sweep_inputs(seed=s, n=200, w=w, points=16) for s, w in
             ((1, (0.5, 0.5, 1.0)), (2, (0.9, 0.1, 2.0)), (3, (0.0, 1.0, 1.0)))]
    stacked = [torch.tensor(np.stack(xs)) for xs in zip(*cells)]
    batched = sp1_sweep.sp1_lambda_sum_ref(*stacked).numpy()
    assert batched.shape == (3, 16)
    for c, xs in enumerate(cells):
        np.testing.assert_allclose(batched[c], _port_sum(*xs), rtol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pure_latency_weighting_stays_finite(dtype):
    """w1 = 0 makes k3 = 0: the lambda = 0 candidate must not become
    cbrt(0/0)."""
    T_grid, q, tt, consts = _sweep_inputs(n=64, w=(0.0, 1.0, 1.0))
    assert consts[0] == 0.0
    out = _port_sum(T_grid, q, tt, consts, dtype=dtype)
    assert np.all(np.isfinite(out))
    ref = jax_ref(*(jnp.asarray(x, dtype=np.dtype(str(dtype)[6:]))
                    for x in (T_grid, q, tt, consts)))
    np.testing.assert_allclose(out, np.asarray(ref),
                               rtol=1e-5 if dtype == torch.float32 else 1e-12)


def test_zero_lanes_add_exactly_zero():
    """q = tt = 0 lanes (the TPU kernel's tail padding; the CUDA kernel's
    masked lanes write 0) give lambda exactly 0."""
    T_grid, q, tt, consts = _sweep_inputs(n=40)
    k = [torch.tensor(consts[i]) for i in range(7)]
    zero = torch.zeros(8, dtype=torch.float64)
    lam = sp1_sweep.lambda_of_T_linear(torch.tensor(T_grid)[:, None],
                                       zero[None], zero[None], *k)
    assert torch.equal(lam, torch.zeros_like(lam))
    padded = [np.concatenate([x, np.zeros(24)]) for x in (q, tt)]
    np.testing.assert_allclose(_port_sum(T_grid, *padded, consts),
                               _port_sum(T_grid, q, tt, consts), rtol=1e-15)


def test_ops_entry_runs_plain_version_on_cpu():
    xs = [torch.tensor(x)[None] for x in _sweep_inputs(n=50, points=16)]
    launches = sp1_sweep.sp1_lambda_sum.launches
    out = ops.sp1_lambda_sum(*xs)
    assert torch.equal(out, sp1_sweep.sp1_lambda_sum_ref(*xs))
    assert sp1_sweep.sp1_lambda_sum.launches == launches


def test_kernel_wrapper_refuses_cpu_tensors():
    xs = [torch.tensor(x)[None] for x in _sweep_inputs(n=50, points=16)]
    with pytest.raises(ValueError, match="CUDA"):
        sp1_sweep.sp1_lambda_sum(*xs)
