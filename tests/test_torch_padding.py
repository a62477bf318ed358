"""`repro_torch.region.batch` (padding mixed-size cell pools) against
`repro.region.batch`, on the CPU.

The reference claims bit-identity of a padded solve's active prefix with
the unpadded solve, and fails that claim itself under jax 0.9.0
(`tests/test_region_padding.py::test_warm_start_padding_parity`,
`test_padding_property_f32`). The port is held to the properties that do
hold: pad lanes get B = 0 and zero energy exactly, the prefix passes the
masked KKT check, the prefix is within a stated tolerance of the unpadded
port solve (float32 sweeps move by a few ulps of a reduction in the
bracket pick), and the padded solve matches `repro`'s padded solve.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

import repro
from repro.core.types import _SYS_ARRAYS, _SYS_SCALARS
from repro.region import batch as batch_j

import repro_torch as rt
from repro_torch import interop
from repro_torch.core.accuracy import default_accuracy
from repro_torch.core.energy import e_cmp, e_trans, rate
from repro_torch.core.sp1 import _coeffs, _lambda_of_T, _sp1_bounds
from repro_torch.region import (bucket_size, inactive_system, pad_allocation,
                                pad_system)

FIELDS = ("bandwidth", "power", "freq", "resolution")
# prefix of a padded port solve vs the unpadded port solve, relative to
# each field's largest value (measured: <= 2.4e-15 in float64; <= 5.8e-5 in
# float32, where the sweep's bracket pick sees reductions over 7 or 16
# lanes round differently)
PREFIX_TOL = {torch.float64: 1e-12, torch.float32: 1e-3}
# port vs repro, both padded (float64 as tests/test_torch_solve.py)
REPRO_TOL = {torch.float64: 1e-6, torch.float32: 1e-3}


def to_port(sj, dtype=None):
    leaves = {k: np.asarray(getattr(sj, k)) for k in _SYS_ARRAYS + _SYS_SCALARS}
    if sj.active is not None:
        leaves["active"] = np.asarray(sj.active)
    return interop.system_from_numpy(leaves, sj.resolutions, device="cpu",
                                     dtype=dtype)


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def pad_lanes_neutral(spad, res, n):
    a = res.allocation
    assert torch.equal(a.bandwidth[..., n:],
                       torch.zeros_like(a.bandwidth[..., n:]))
    e = (e_trans(spad, a.bandwidth, a.power)
         + e_cmp(spad, a.freq, a.resolution))[..., n:]
    assert torch.equal(e, torch.zeros_like(e))


def check_prefix_kkt(sysp, w, res_pad, n, lam_tol=1e-3):
    """Feasibility and SP1 dual feasibility of the active prefix, on the
    UNPADDED system (tests/test_region_padding.py::_check_prefix_kkt)."""
    a = res_pad.allocation
    alloc = rt.Allocation(*(getattr(a, f)[:n] for f in FIELDS))
    assert rt.core.energy.feasible(sysp, alloc)
    w = w.normalized()
    b = sysp.batched()
    wt = rt.Weights(*(torch.tensor([[float(x)]], dtype=b.dtype)
                      for x in (w.w1, w.w2, w.rho)))
    tt = b.bits / torch.clamp_min(rate(b, alloc.bandwidth[None],
                                       alloc.power[None]), 1e-12)
    _, q = _coeffs(b, wt)
    s_hat = a.s_relaxed[:n][None]
    mk_hat = q * s_hat ** 2 / torch.clamp_min(alloc.freq[None], 1e-9) + tt
    lam_hi, target, T_lo, _ = _sp1_bounds(b, wt, q, tt)
    lam = _lambda_of_T(b, wt, default_accuracy(), mk_hat.amax(-1,
                                                              keepdim=True),
                       tt, lam_hi)
    total, target = float(lam.sum()), float(target)
    if float(mk_hat.max()) <= float(T_lo) * (1 + 1e-9):
        assert total <= target * (1 + lam_tol)
    else:
        assert total == pytest.approx(target, rel=lam_tol)


def test_bucket_size_policy():
    assert bucket_size(1, min_bucket=16) == 16
    assert bucket_size(16, min_bucket=16) == 16
    assert bucket_size(17, min_bucket=16) == 32
    assert bucket_size(50) == 64
    assert bucket_size(65) == 128
    assert bucket_size(2048) == 2048
    with pytest.raises(ValueError):
        bucket_size(0)
    assert len({bucket_size(n) for n in range(1, 1025)}) == 5
    for n in (1, 5, 63, 64, 65, 1025, 2047):
        assert bucket_size(n) == batch_j.bucket_size(n)


def test_pad_system_validates():
    sj = repro.make_system(jax.random.PRNGKey(0), n_devices=5)
    sysp = to_port(sj)
    with pytest.raises(ValueError):
        pad_system(sysp, 4)
    spad = pad_system(sysp, 9)
    assert spad.n == 9
    assert spad.active.tolist() == [True] * 5 + [False] * 4
    assert torch.equal(spad.bits[5:], torch.zeros(4, dtype=spad.dtype))
    # re-padding a padded system keeps the original mask prefix
    assert pad_system(spad, 12).active.tolist() == [True] * 5 + [False] * 7
    # every leaf equals the reference's padded system
    ref = batch_j.pad_system(sj, 9)
    for k in _SYS_ARRAYS + ("active",):
        np.testing.assert_array_equal(getattr(spad, k).numpy(),
                                      np.asarray(getattr(ref, k)))
    # a stack pads along its device axis; host assembly on the CPU
    stack = rt.stack_systems([sysp, sysp])
    sp2 = pad_system(stack, 8, device="cpu")
    assert sp2.gain.shape == (2, 8) and sp2.device.type == "cpu"
    assert sp2.active[:, 5:].any().item() is False
    with pytest.raises(ValueError):
        pad_allocation(rt.Allocation(*(torch.zeros(5),) * 4), 4, sysp)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("sp1_method", ["sweep", "bisect"])
def test_padded_prefix_matches(dtype, sp1_method):
    n, n_pad = 7, 16
    sj = repro.make_system(jax.random.PRNGKey(3), n_devices=n)
    sysp = to_port(sj, dtype)
    w = rt.Weights(0.5, 0.5, 5.0)
    spec = rt.SolverSpec(max_iters=6, sp1_method=sp1_method)
    res = rt.solve(rt.Problem(system=sysp, weights=w), spec)
    spad = pad_system(sysp, n_pad)
    res_pad = rt.solve(rt.Problem(system=spad, weights=w), spec)
    assert res_pad.iters == res.iters
    assert res_pad.converged == res.converged
    tol = PREFIX_TOL[dtype]
    for f in FIELDS:
        assert rel_err(getattr(res_pad.allocation, f)[:n],
                       getattr(res.allocation, f)) <= tol, f
    assert res_pad.objective == pytest.approx(res.objective, rel=tol)
    pad_lanes_neutral(spad, res_pad, n)
    check_prefix_kkt(sysp, w, res_pad, n)

    # against repro's padded solve
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    spad_j = batch_j.pad_system(
        jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), sj), n_pad)
    rj = repro.solve(repro.Problem(system=spad_j,
                                   weights=repro.Weights(0.5, 0.5, 5.0)),
                     repro.SolverSpec(max_iters=6, sp1_method=sp1_method))
    assert res_pad.iters == rj.iters
    assert res_pad.objective == pytest.approx(rj.objective,
                                              rel=REPRO_TOL[dtype])
    for f in FIELDS:
        assert rel_err(getattr(res_pad.allocation, f),
                       torch.as_tensor(np.array(getattr(rj.allocation, f)))
                       ) <= REPRO_TOL[dtype], f
    np.testing.assert_array_equal(res_pad.allocation.bandwidth[n:].numpy(),
                                  np.asarray(rj.allocation.bandwidth)[n:])


def test_pad_to_same_size_attaches_mask_only():
    sysp = to_port(repro.make_system(jax.random.PRNGKey(5), n_devices=6))
    spad = pad_system(sysp, 6)
    assert spad.active is not None and bool(spad.active.all())
    w = rt.Weights(0.5, 0.5, 1.0)
    res = rt.solve(rt.Problem(system=sysp, weights=w), rt.SolverSpec(
        max_iters=5))
    res_pad = rt.solve(rt.Problem(system=spad, weights=w), rt.SolverSpec(
        max_iters=5))
    assert res_pad.iters == res.iters
    for f in FIELDS:
        assert torch.equal(getattr(res_pad.allocation, f),
                           getattr(res.allocation, f)), f


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mixed_pool_with_inactive_filler(dtype):
    """Cells of 5, 7 and 11 devices padded onto one 16-lane bucket and
    stacked with an all-inactive filler cell: one solve; each cell's
    prefix is its own unpadded solve's, and the filler converges after one
    iteration with a zero objective, as in repro."""
    sizes, n_pad = (5, 7, 11), bucket_size(11, min_bucket=16)
    cells_j = [repro.make_system(jax.random.PRNGKey(k), n_devices=n)
               for k, n in zip((1, 2, 4), sizes)]
    cells = [to_port(c, dtype) for c in cells_j]
    padded = [pad_system(c, n_pad) for c in cells]
    pool = rt.stack_systems(padded + [inactive_system(padded[0])])
    w = rt.Weights(0.5, 0.5, 1.0)
    spec = rt.SolverSpec(max_iters=8)
    res = rt.solve(rt.Problem(system=pool, weights=w), spec)
    assert res.iters[-1].item() == 1 and bool(res.converged[-1])
    assert res.objective[-1].item() == 0.0
    assert torch.equal(res.allocation.bandwidth[-1],
                       torch.zeros(n_pad, dtype=dtype))
    for c, (cell, n) in enumerate(zip(cells, sizes)):
        one = rt.solve(rt.Problem(system=cell, weights=w), spec)
        assert res.iters[c].item() == one.iters
        for f in FIELDS:
            assert rel_err(getattr(res.allocation, f)[c, :n],
                           getattr(one.allocation, f)) <= PREFIX_TOL[dtype]
        assert torch.equal(res.allocation.bandwidth[c, n:],
                           torch.zeros(n_pad - n, dtype=dtype))

    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    pj = [batch_j.pad_system(jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jdt), c), n_pad) for c in cells_j]
    pool_j = repro.stack_systems(pj + [batch_j.inactive_system(pj[0])])
    rj = repro.solve(repro.Problem(system=pool_j,
                                   weights=repro.Weights(0.5, 0.5, 1.0)),
                     repro.SolverSpec(max_iters=8))
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_allclose(res.objective.numpy(), np.asarray(rj.objective),
                               rtol=REPRO_TOL[dtype])


def test_warm_start_padding():
    """pad_allocation fills pad lanes at the masked fixed point, so a padded
    warm re-solve takes the iterations of the unpadded warm re-solve (and
    of repro's), far fewer than the cold solve, and its prefix matches.

    The reference's version of this test caps the cold solve at 40 BCD
    iterations and the warm one at 3; both fail in repro itself (the cold
    solve converges at iteration 41, the warm re-solve takes 4), so the
    cold solve here may run to 80 and the warm iterations are compared."""
    n, n_pad = 12, 16
    sj = repro.make_system(jax.random.PRNGKey(40), n_devices=n)
    sysp = to_port(sj)
    w = rt.Weights(0.5, 0.5, 1.0)
    spec = rt.SolverSpec(max_iters=80, tol=1e-8)
    base = rt.solve(rt.Problem(system=sysp, weights=w), spec)
    assert base.converged
    bump = 1.0 + 0.02 * torch.sin(torch.arange(float(n), dtype=torch.float64))
    sys2 = sysp.replace(gain=sysp.gain * bump)
    warm = rt.solve(rt.Problem(system=sys2, weights=w, init=base.allocation),
                    spec)
    spad = pad_system(sys2, n_pad)
    init_pad = pad_allocation(base.allocation, n_pad, spad)
    assert torch.equal(init_pad.bandwidth[n:], torch.zeros(n_pad - n,
                                                           dtype=torch.float64))
    assert torch.equal(init_pad.resolution[n:],
                       torch.full((n_pad - n,), sysp.s_hi,
                                  dtype=torch.float64))
    warm_pad = rt.solve(rt.Problem(system=spad, weights=w, init=init_pad),
                        spec)
    assert warm_pad.iters == warm.iters and warm.iters * 5 < base.iters
    spec_j = repro.SolverSpec(max_iters=80, tol=1e-8)
    wj = repro.Weights(0.5, 0.5, 1.0)
    base_j = repro.solve(repro.Problem(system=sj, weights=wj), spec_j)
    assert base_j.iters == base.iters
    s2j = sj.replace(gain=sj.gain * np.asarray(bump))
    warm_j = repro.solve(repro.Problem(system=s2j, weights=wj,
                                       init=base_j.allocation), spec_j)
    assert warm_j.iters == warm.iters
    for f in FIELDS:
        assert rel_err(getattr(warm_pad.allocation, f)[:n],
                       getattr(warm.allocation, f)) <= 1e-12, f
    pad_lanes_neutral(spad, warm_pad, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_zero_data_lanes_sum_to_zero_in_the_plain_version(dtype):
    """The SP1 sweep's plain version (the CPU path, and what the CUDA
    kernel is held against on the card) gives every padded lane (q = 0,
    tt = 0) lambda = 0 exactly at every candidate deadline of a padded
    cell's sweep, so the cell's sums are its unpadded prefix's (up to the
    order torch's sum adds 37 or 64 terms in: a few ulps)."""
    from repro_torch.core.bcd import initial_allocation
    from repro_torch.core.sp1 import _SWEEP_POINTS, _geomspace, _sweep_consts
    from repro_torch.kernels.sp1_sweep import (lambda_of_T_linear,
                                               sp1_lambda_sum_ref)

    n, n_pad = 37, 64
    sysp = to_port(repro.make_system(jax.random.PRNGKey(9), n_devices=n),
                   dtype)
    for w in ((0.5, 0.5, 1.0), (0.0, 1.0, 1.0)):
        b = pad_system(sysp, n_pad).batched()
        a = initial_allocation(b)
        tt = b.bits / torch.clamp_min(rate(b, a.bandwidth, a.power), 1e-12)
        wt = rt.Weights(*(torch.tensor([[x]], dtype=dtype)
                          for x in (w[0], max(w[1], 1e-9), w[2])))
        _, q = _coeffs(b, wt)
        lam_hi, _, T_lo, T_hi = _sp1_bounds(b, wt, q, tt)
        consts = _sweep_consts(b, wt, default_accuracy(), lam_hi)
        grid = _geomspace(T_lo, T_hi, _SWEEP_POINTS)
        assert torch.equal(q[:, n:], torch.zeros_like(q[:, n:]))
        assert torch.equal(tt[:, n:], torch.zeros_like(tt[:, n:]))
        k = [consts[:, i, None, None] for i in range(7)]
        lam = lambda_of_T_linear(grid[:, :, None], q[:, None, :],
                                 tt[:, None, :], *k)
        assert torch.equal(lam[..., n:], torch.zeros_like(lam[..., n:]))
        full = sp1_lambda_sum_ref(grid, q, tt, consts)
        prefix = sp1_lambda_sum_ref(grid, q[:, :n].contiguous(),
                                    tt[:, :n].contiguous(), consts)
        np.testing.assert_allclose(full.numpy(), prefix.numpy(),
                                   rtol=8 * torch.finfo(dtype).eps)
