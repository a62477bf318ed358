"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where there is no CUDA device;
the file imports neither JAX nor `repro`, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import make_fleet
from repro_torch.core.accuracy import default_accuracy
from repro_torch.core.sp1 import _coeffs, _sp1_bounds, _sweep_consts
from repro_torch.core.types import Weights
from repro_torch.kernels import sp1_sweep, waterfill


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def sweep_inputs(device, dtype, n, w=(0.5, 0.5, 1.0), cells=3, points=16):
    """Kernel inputs for `cells` cells at the equal-split start, with a
    geometric T-grid from 1.01x the slowest floor (off the attainability
    edge, where float32 rounding decides a tie)."""
    sysp = make_fleet(11, cells, n, device=device, dtype=dtype,
                      bandwidth_total=20e6 * n / 50)
    from repro_torch.core.bcd import initial_allocation
    from repro_torch.core.energy import rate

    a = initial_allocation(sysp)
    tt = sysp.bits / torch.clamp_min(rate(sysp, a.bandwidth, a.power), 1e-12)
    w1, w2, rho = (x / (w[0] + w[1]) for x in w)
    wt = Weights(w1, max(w2, 1e-9), rho)
    _, q = _coeffs(sysp, wt)
    lam_hi, _, T_lo, _ = _sp1_bounds(sysp, wt, q, tt)
    consts = _sweep_consts(sysp, wt, default_accuracy(), lam_hi)
    ramp = torch.logspace(0, math.log10(1e4), points, dtype=dtype,
                          device=device)
    T_grid = (T_lo * 1.01 * ramp).contiguous()
    return T_grid, q.contiguous(), tt.contiguous(), consts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, w", [(5, (0.5, 0.5, 1.0)), (1500, (0.5, 0.5, 1.0)),
                                  (2048, (0.5, 0.5, 1.0)),
                                  (1500, (0.0, 1.0, 1.0))])
def test_sp1_lambda_sum_matches_plain_version(cuda, dtype, n, w):
    xs = sweep_inputs(cuda, dtype, n, w)
    launches = sp1_sweep.sp1_lambda_sum.launches
    out = sp1_sweep.sp1_lambda_sum(*xs)
    again = sp1_sweep.sp1_lambda_sum(*xs)
    plain = sp1_sweep.sp1_lambda_sum_ref(*xs)
    torch.cuda.synchronize()
    assert sp1_sweep.sp1_lambda_sum.launches == launches + 2
    assert torch.equal(out, again)     # fixed-order sums: bitwise repeatable
    assert bool(torch.isfinite(out).all())
    if dtype == torch.float64:
        scale, tol = plain.abs().clamp_min(torch.finfo(dtype).tiny), 1e-10
    else:
        scale, tol = torch.maximum(plain.abs(), 1e-6 * xs[3][:, 6:7] * n), 1e-4
    assert float(((out - plain).abs() / scale).max()) <= tol


@pytest.mark.cuda
def test_sp1_lambda_sum_rejects_bad_inputs(cuda):
    T, q, tt, consts = sweep_inputs(cuda, torch.float32, 64)
    with pytest.raises(TypeError):
        sp1_sweep.sp1_lambda_sum(T.double(), q, tt, consts)
    with pytest.raises(ValueError):
        sp1_sweep.sp1_lambda_sum(T, q[:, :32], tt, consts)
    with pytest.raises(ValueError):
        sp1_sweep.sp1_lambda_sum(T, q.cpu(), tt, consts)


@pytest.mark.cuda
def test_solve_on_the_card_runs_the_kernel(cuda):
    from repro_torch import Problem, SolverSpec, solve

    sysp = make_fleet(3, 4, 256, device=cuda, dtype=torch.float64,
                      bandwidth_total=20e6 * 256 / 50)
    sp1_sweep.sp1_lambda_sum.launches = 0
    res = solve(Problem(system=sysp, weights=Weights(0.5, 0.5, 1.0)),
                SolverSpec(max_iters=8))
    assert sp1_sweep.sp1_lambda_sum.launches == 3 * int(res.iters.max())
    cpu = solve(Problem(system=sysp.to("cpu"),
                        weights=Weights(0.5, 0.5, 1.0)),
                SolverSpec(max_iters=8))
    np.testing.assert_allclose(res.objective.cpu().numpy(),
                               cpu.objective.numpy(), rtol=1e-8)
    assert torch.equal(res.iters.cpu(), cpu.iters)


def kernel_order_sum(lam, block=sp1_sweep.BLOCK_N):
    """Sigma_n lam (C, M, N) -> (C, M) in csrc/sp1_sweep.cu's order: the
    devices in blocks of `block` (lanes past N add exact zeros), per warp
    of 32 lanes a shuffle butterfly (lane l takes lane l + 16, then l + 8,
    + 4, + 2, + 1), the warps of a block in order, then the blocks in order
    from 0."""
    C, M, N = lam.shape
    blocks = -(-N // block)
    x = torch.nn.functional.pad(lam, (0, blocks * block - N)).reshape(
        C, M, blocks, block // 32, 32)
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    warps = x[..., 0]
    acc = warps[..., 0]
    for w in range(1, warps.shape[-1]):
        acc = acc + warps[..., w]
    out = torch.zeros((C, M), dtype=lam.dtype, device=lam.device)
    for b in range(blocks):
        out = out + acc[..., b]
    return out


def assert_sp1_matches_plain(out, plain, consts, n):
    """The kernel's sums against the plain version's at the tolerances of
    `test_sp1_lambda_sum_matches_plain_version`."""
    if out.dtype == torch.float64:
        scale, tol = plain.abs().clamp_min(torch.finfo(out.dtype).tiny), 1e-10
    else:
        scale, tol = torch.maximum(plain.abs(), 1e-6 * consts[:, 6:7] * n), \
            1e-4
    assert float(((out - plain).abs() / scale).max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("C", [1, 3, 64])
@pytest.mark.parametrize("N", [1, 31, 32, 33, 257, 2049])
@pytest.mark.parametrize("M", [1, 8, 15, 16, 17, 40])
def test_sp1_lambda_sum_every_tile_and_block_edge(cuda, M, N, C, dtype):
    """M around the 16-candidate tile, N around a warp and a 256-device
    block, C up to the fleet's 64 cells: bitwise repeatable, finite, within
    the plain version's tolerance, one count per call."""
    xs = sweep_inputs(cuda, dtype, N, cells=C, points=M)
    launches = sp1_sweep.sp1_lambda_sum.launches
    out = sp1_sweep.sp1_lambda_sum(*xs)
    again = sp1_sweep.sp1_lambda_sum(*xs)
    plain = sp1_sweep.sp1_lambda_sum_ref(*xs)
    torch.cuda.synchronize()
    assert out.shape == (C, M)
    assert sp1_sweep.sp1_lambda_sum.launches == launches + 2
    assert torch.equal(out, again)
    assert bool(torch.isfinite(out).all())
    assert_sp1_matches_plain(out, plain, xs[3], N)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 31, 33, 257, 2049])
def test_sp1_lambda_sum_lanes_past_n_add_zero(cuda, dtype, n):
    """At T = 0 no device can meet its deadline and every live lane's term
    is lam_hi exactly; at T = 1e30 every device meets it at lambda = 0. The
    sums must be the fixed-order sums of those terms bit for bit, and 0:
    a lane past N that added anything but 0 would show."""
    T, q, tt, consts = sweep_inputs(cuda, dtype, n, cells=3, points=4)
    T = torch.cat([torch.zeros_like(T), torch.full_like(T, 1e30)], 1)
    out = sp1_sweep.sp1_lambda_sum(T, q, tt, consts)
    torch.cuda.synchronize()
    lam_hi = consts[:, 6, None, None].expand(-1, 4, n)
    assert torch.equal(out[:, :4], kernel_order_sum(lam_hi.contiguous()))
    assert torch.equal(out[:, 4:], torch.zeros_like(out[:, 4:]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, points", [(1, 16), (33, 17), (2049, 16)])
def test_sp1_lambda_sum_w1_zero_is_finite(cuda, dtype, n, points):
    """w1 = 0 makes k3 = 0: the guards keep every term finite."""
    xs = sweep_inputs(cuda, dtype, n, w=(0.0, 1.0, 1.0), points=points)
    assert bool((xs[3][:, 0] == 0).all())
    out = sp1_sweep.sp1_lambda_sum(*xs)
    plain = sp1_sweep.sp1_lambda_sum_ref(*xs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert_sp1_matches_plain(out, plain, xs[3], n)


def zero_tail(q, tt, tails):
    """q and tt with the last tails[c] lanes of cell c zeroed (padded
    devices: no data, no transmission), and one all-zero cell appended."""
    q, tt = q.clone(), tt.clone()
    n = q.shape[1]
    for c, t in enumerate(tails):
        q[c, n - t:] = 0.0
        tt[c, n - t:] = 0.0
    zero = torch.zeros_like(q[:1])
    return torch.cat([q, zero]), torch.cat([tt, zero])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2, 33, 257, 2048])
def test_sp1_lambda_sum_zero_data_lanes_add_zero(cuda, dtype, n):
    """Padded devices sit inside N with q = 0 and tt = 0 (region.batch).
    Each such lane's term is exactly 0 at every finite deadline: a cell's
    sums equal, bit for bit, the kernel's sums over the cell's non-zero
    prefix alone, an all-zero cell sums to 0.0 exactly, and the plain
    version agrees (its zero lanes are exactly 0 too)."""
    T, q, tt, consts = sweep_inputs(cuda, dtype, n, cells=3, points=16)
    tails = [1, n // 2, n - 1]
    qz, ttz = zero_tail(q, tt, tails)
    Tz = torch.cat([T, T[:1]]).contiguous()
    cz = torch.cat([consts, consts[:1]]).contiguous()
    out = sp1_sweep.sp1_lambda_sum(Tz, qz, ttz, cz)
    plain = sp1_sweep.sp1_lambda_sum_ref(Tz, qz, ttz, cz)
    k = [cz[:, i, None, None] for i in range(7)]
    lam = sp1_sweep.lambda_of_T_linear(Tz[:, :, None], qz[:, None, :],
                                       ttz[:, None, :], *k)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out[3], torch.zeros_like(out[3]))
    assert torch.equal(plain[3], torch.zeros_like(plain[3]))
    for c, t in enumerate(tails):
        assert torch.equal(lam[c, :, n - t:], torch.zeros_like(
            lam[c, :, n - t:]))
        keep = n - t
        alone = sp1_sweep.sp1_lambda_sum(
            T[c:c + 1].contiguous(), q[c:c + 1, :keep].contiguous(),
            tt[c:c + 1, :keep].contiguous(), consts[c:c + 1].contiguous())
        assert torch.equal(out[c:c + 1], alone), c
    assert_sp1_matches_plain(out, plain, cz, n)


@pytest.mark.cuda
def test_sp1_lambda_sum_counts_one_launch_per_call(cuda):
    xs = sweep_inputs(cuda, torch.float32, 300)
    before = sp1_sweep.sp1_lambda_sum.launches
    for _ in range(3):
        sp1_sweep.sp1_lambda_sum(*xs)
    assert sp1_sweep.sp1_lambda_sum.launches == before + 3
    with pytest.raises(TypeError):                # refused: not counted
        sp1_sweep.sp1_lambda_sum(xs[0].double(), *xs[1:])
    assert sp1_sweep.sp1_lambda_sum.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("block_n, takes", [(0, False), (16, False),
                                             (48, False), (512, False),
                                             (1024, False), (32, True),
                                             (64, True), (128, True),
                                             (256, True)])
def test_sp1_entry_takes_only_its_block_shapes(cuda, block_n, takes):
    """The C entry takes blocks of 32 to 256 devices, a power of two, and
    refuses any other with cudaErrorInvalidValue before launching."""
    T, q, tt, consts = sweep_inputs(cuda, torch.float32, 300)
    C, M = T.shape
    N = q.shape[1]
    chunks = -(-N // max(block_n, 1))
    partials = torch.empty((C, chunks, M), dtype=T.dtype, device=cuda)
    out = torch.full((C, M), float("nan"), dtype=T.dtype, device=cuda)
    lib = sp1_sweep._lib()
    rc = lib.sp1_lambda_sum_f32(
        T.data_ptr(), q.data_ptr(), tt.data_ptr(), consts.data_ptr(),
        partials.data_ptr(), out.data_ptr(), C, M, N, block_n,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if not takes:
        assert rc != 0
        assert lib.sp1_error_string(rc) == b"invalid argument"
        assert bool(torch.isnan(out).all())
        return
    assert rc == 0
    assert_sp1_matches_plain(out, sp1_sweep.sp1_lambda_sum_ref(
        T, q, tt, consts), consts, N)


def waterfill_inputs(device, dtype, n, cells=2, m=128, seed=5):
    """A multiplier grid across the branch point (q = mu/j from ~1e-6 up)
    and far above it, over device coefficients of the SP2 dual's scale."""
    gen = torch.Generator().manual_seed(seed)
    j = torch.rand((cells, n), generator=gen, dtype=torch.float64) * 1e-3 \
        + 1e-5
    rmin = torch.rand((cells, n), generator=gen, dtype=torch.float64) * 1e5
    mu = torch.logspace(-9, 3, m, dtype=torch.float64).expand(cells, m)
    b_total = torch.tensor([20e6 * n / 50] * cells, dtype=torch.float64)
    return tuple(x.to(device=device, dtype=dtype).contiguous()
                 for x in (mu, j, rmin, b_total))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [7, 1000, 1500, 2048])
def test_waterfill_gprime_matches_plain_version(cuda, dtype, n):
    xs = waterfill_inputs(cuda, dtype, n)
    launches = waterfill.waterfill_gprime.launches
    out = waterfill.waterfill_gprime(*xs)
    again = waterfill.waterfill_gprime(*xs)
    plain = waterfill.waterfill_gprime_ref(*xs)
    torch.cuda.synchronize()
    assert waterfill.waterfill_gprime.launches == launches + 2
    assert torch.equal(out, again)     # fixed-order sums: bitwise repeatable
    assert bool(torch.isfinite(out).all())
    mu, j, rmin, b_total = xs
    # scale: the positive sum g + B_total, at least Sigma rmin ln2. In
    # float32 a term near the branch point has W + 1 ~ sqrt(2q) formed from
    # -1 + p(...), so its relative rounding is ~6e-8 / sqrt(2q) (4e-5 at
    # q = 1e-6), so a last-bit difference between the two versions' exp,
    # log or sums is amplified there
    scale = torch.maximum((plain + b_total[:, None]).abs(),
                          rmin.sum(-1, keepdim=True) * math.log(2.0))
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    assert float(((out - plain).abs() / scale).max()) <= tol
    assert torch.equal(out < 0, plain < 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m, n", [(1, 1000), (17, 1000), (128, 1000),
                                  (1, 1), (17, 1), (128, 1)])
def test_waterfill_gprime_candidate_tiles_and_one_device(cuda, dtype, m, n):
    """M = 17 leaves the last tile of 8 candidates with 1; N = 1000 leaves
    the last block of 256 devices with 232 (a ragged warp); N = 1 is one
    live lane."""
    xs = waterfill_inputs(cuda, dtype, n, m=m)
    launches = waterfill.waterfill_gprime.launches
    out = waterfill.waterfill_gprime(*xs)
    again = waterfill.waterfill_gprime(*xs)
    plain = waterfill.waterfill_gprime_ref(*xs)
    torch.cuda.synchronize()
    assert out.shape == (2, m)
    assert waterfill.waterfill_gprime.launches == launches + 2
    assert torch.equal(out, again)
    assert bool(torch.isfinite(out).all())
    mu, j, rmin, b_total = xs
    scale = torch.maximum((plain + b_total[:, None]).abs(),
                          rmin.sum(-1, keepdim=True) * math.log(2.0))
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    assert float(((out - plain).abs() / scale).max()) <= tol
    assert torch.equal(out < 0, plain < 0)


@pytest.mark.cuda
def test_waterfill_gprime_rejects_bad_inputs(cuda):
    mu, j, rmin, b = waterfill_inputs(cuda, torch.float32, 64)
    with pytest.raises(TypeError):
        waterfill.waterfill_gprime(mu.double(), j, rmin, b)
    with pytest.raises(ValueError):
        waterfill.waterfill_gprime(mu, j.t().contiguous().t(), rmin, b)
    with pytest.raises(ValueError):
        waterfill.waterfill_gprime(mu, j[0], rmin, b)
    with pytest.raises(ValueError):
        waterfill.waterfill_gprime(mu, j, rmin[:, :32], b)
    with pytest.raises(ValueError):
        waterfill.waterfill_gprime(mu, j.cpu(), rmin, b)


@pytest.mark.cuda
def test_thm2_on_the_card_launches_the_sweep(cuda):
    from repro_torch.core import sp2
    from repro_torch.core.loops import while_cells

    sysp = make_fleet(7, 3, 512, device=cuda, dtype=torch.float64,
                      bandwidth_total=20e6 * 512 / 50)
    B0 = torch.broadcast_to(sysp.bandwidth_total / 512, sysp.gain.shape)
    p0 = torch.broadcast_to(sysp.p_max, sysp.gain.shape)
    rate0 = sp2.G(sysp, p0, B0)
    rmin = 0.9 * rate0
    nu = 0.5 * sysp.global_rounds / rate0
    beta = p0 * sysp.bits / rate0
    waterfill.waterfill_gprime.launches = 0
    while_cells.host_reads = 0
    p, B = sp2.solve_sp2_v2_thm2(sysp, Weights(0.5, 0.5, 1.0), nu, beta,
                                 rmin)
    torch.cuda.synchronize()
    assert waterfill.waterfill_gprime.launches == 4
    assert while_cells.host_reads == 0
    cpu = sysp.to("cpu")
    p1, B1 = sp2.solve_sp2_v2_thm2(cpu, Weights(0.5, 0.5, 1.0), nu.cpu(),
                                   beta.cpu(), rmin.cpu())
    np.testing.assert_allclose(B.cpu().numpy(), B1.numpy(), rtol=1e-10)
    np.testing.assert_allclose(p.cpu().numpy(), p1.numpy(), rtol=1e-10)


@pytest.mark.cuda
def test_deadline_solve_on_the_card_matches_the_cpu(cuda):
    """The deadline BCD's SP1 is a closed-form enumeration and its SP2 the
    direct search: it launches neither dual-sweep kernel."""
    from repro_torch import Problem, SolverSpec, solve

    sysp = make_fleet(3, 4, 256, device=cuda, dtype=torch.float64,
                      bandwidth_total=20e6 * 256 / 50)
    deadlines = torch.tensor([60.0, 80.0, 100.0, 120.0], dtype=torch.float64)
    sp1_sweep.sp1_lambda_sum.launches = 0
    waterfill.waterfill_gprime.launches = 0
    res = solve(Problem(system=sysp, weights=Weights(0.99, 0.01, 1.0),
                        deadline=deadlines.to(cuda)), SolverSpec(max_iters=6))
    assert sp1_sweep.sp1_lambda_sum.launches == 0
    assert waterfill.waterfill_gprime.launches == 0
    cpu = solve(Problem(system=sysp.to("cpu"), weights=Weights(0.99, 0.01,
                                                               1.0),
                        deadline=deadlines), SolverSpec(max_iters=6))
    np.testing.assert_allclose(res.objective.cpu().numpy(),
                               cpu.objective.numpy(), rtol=1e-8)
    assert torch.equal(res.iters.cpu(), cpu.iters)


def flash_inputs(device, dtype, B, H, KV, S, T, hd, vd=None, seed=0):
    rng = np.random.default_rng(seed)
    vd = hd if vd is None else vd
    # unit-variance q and k: scores of unit spread, so the softmax is far
    # from uniform and |o| is not held small by averaging
    q = rng.standard_normal((B, H, S, hd))
    k = rng.standard_normal((B, KV, T, hd))
    v = rng.standard_normal((B, KV, T, vd))
    return tuple(torch.tensor(x, dtype=torch.float32).to(device=device,
                                                         dtype=dtype)
                 for x in (q, k, v))


def flash_spread(q, k, v, causal, window):
    """sqrt(sum_t p_st^2 v_t^2) per output element, P the plain version's
    softmax (default scale)."""
    G, S, T = q.shape[1] // k.shape[1], q.shape[2], k.shape[2]
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    hidden = (kpos > qpos) if causal else torch.zeros_like(kpos > qpos)
    if window is not None:
        hidden = hidden | (kpos <= qpos - window)
    kh = k.float().repeat_interleave(G, 1)
    vh = v.float().repeat_interleave(G, 1)
    sc = q.float() @ kh.transpose(-1, -2) * q.shape[-1] ** -0.5
    p = torch.softmax(sc.masked_fill(hidden, -1e30), -1)
    return ((p * p) @ (vh * vh)).sqrt()


# the shapes of tests/test_kernels.py (MHA, GQA 2:1, MQA) with and without a
# 128-key window, a ragged causal S, a non-causal T != S, and vd != hd
FLASH_CASES = [
    (1, 2, 2, 128, 128, 64, None, True, None),
    (2, 4, 2, 256, 256, 64, None, True, None),
    (1, 8, 1, 128, 128, 128, None, True, None),
    (2, 4, 2, 256, 256, 64, None, True, 128),
    (1, 8, 1, 200, 200, 128, None, True, 128),
    (1, 2, 2, 128, 256, 64, None, False, None),
    (2, 4, 2, 77, 77, 32, None, True, None),
    (1, 3, 1, 70, 130, 96, 64, False, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B, H, KV, S, T, hd, vd, causal, window",
                         FLASH_CASES)
def test_flash_attention_matches_plain_version(cuda, dtype, B, H, KV, S, T,
                                               hd, vd, causal, window):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = flash_inputs(cuda, dtype, B, H, KV, S, T, hd, vd)
    check_flash(q, k, v, causal, window, fa.body(q, k, v))


def check_flash(q, k, v, causal, window, body):
    """Two launches on `body` (counted there and nowhere else), bitwise
    equal, within the allowance of the plain version."""
    from repro_torch.kernels import flash_attention as fa

    assert fa.body(q, k, v) == body
    launches = fa.flash_attention.launches
    by_body = dict(fa.flash_attention.launches_by_body)
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention(q, k, v, causal=causal, window=window)
    plain = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == launches + 2
    assert fa.flash_attention.launches_by_body == {
        b: n + 2 * (b == body) for b, n in by_body.items()}
    assert out.dtype == q.dtype and out.shape == plain.shape
    assert torch.equal(out, again)
    # float32 throughout in both: 2e-5 of |plain| + 2e-6. The 16-bit kernel
    # rounds P to the input type (unit roundoff u) before P V, the plain
    # version keeps it in float32: test_kernels.py's bf16 tolerance of
    # |plain| + 4 u sqrt(sum_t p_t^2 v_t^2) (that rounding's error) + 1e-4
    err = (out.float() - plain.float()).abs()
    if q.dtype == torch.float32:
        allowed = 2e-5 * plain.float().abs() + 2e-6
    else:
        u = 2.0 ** -8 if q.dtype == torch.bfloat16 else 2.0 ** -11
        allowed = 2e-2 * plain.float().abs() + 1e-4 \
            + 4 * u * flash_spread(q, k, v, causal, window)
    assert bool((err <= allowed).all()), float((err / allowed).max())
    return out


# the wgmma body's shapes (16-bit, hd == vd in {64, 128}): ragged S and T,
# a 128-key window, non-causal T != S, a single query row, and GQA 6:1 and
# 8:1 (the served prefills' ratios)
WGMMA_CASES = [
    (1, 2, 2, 128, 128, 64, True, None),
    (2, 6, 1, 200, 200, 128, True, None),
    (1, 8, 1, 256, 256, 128, True, 128),
    (1, 4, 1, 300, 300, 64, True, 128),
    (2, 4, 2, 70, 130, 64, False, None),
    (1, 6, 1, 130, 70, 128, False, None),
    (1, 2, 1, 1, 77, 128, False, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("model_layout", [False, True])
@pytest.mark.parametrize("B, H, KV, S, T, hd, causal, window", WGMMA_CASES)
def test_flash_wgmma_body_matches_plain_version(cuda, dtype, model_layout, B,
                                                H, KV, S, T, hd, causal,
                                                window):
    q, k, v = flash_inputs(cuda, dtype, B, H, KV, S, T, hd)
    if model_layout:   # (B, S, heads, hd) transposed, as the model hands over
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in (q, k, v))
    out = check_flash(q, k, v, causal, window, "wgmma")
    if model_layout:
        from repro_torch.kernels import flash_attention as fa

        assert torch.equal(out, fa.flash_attention(
            *(x.contiguous() for x in (q, k, v)), causal=causal,
            window=window))


# MLA's shapes on the wgmma body (q/k 96, v 64): causal and not, ragged
# S and T, a 128-key window, GQA 2:1 and a single query row.
# (B, H, KV, S, T, causal, window)
MLA_WGMMA_CASES = [
    (1, 2, 2, 128, 128, True, None),
    (2, 4, 4, 200, 200, True, None),
    (1, 3, 3, 256, 256, False, None),
    (1, 3, 1, 70, 130, False, None),
    (2, 4, 2, 130, 70, False, None),
    (1, 4, 4, 300, 300, True, 128),
    (2, 4, 2, 256, 256, True, None),
    (1, 2, 1, 1, 77, False, None),
]


def mla_model_layout(q, k, v):
    """q, k as (B, S, heads, 96) tensors transposed, v the last 64 columns
    of the decompressed (k_nope | v) rows of 128, transposed: MLA's hand-over
    to the kernel."""
    q, k = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k))
    kv = torch.cat([torch.zeros_like(v), v], -1)
    return q, k, kv.transpose(1, 2).contiguous().transpose(1, 2)[..., 64:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("model_layout", [False, True])
@pytest.mark.parametrize("B, H, KV, S, T, causal, window", MLA_WGMMA_CASES)
def test_flash_mla_wgmma_body_matches_plain_version(cuda, dtype, model_layout,
                                                    B, H, KV, S, T, causal,
                                                    window):
    q, k, v = flash_inputs(cuda, dtype, B, H, KV, S, T, 96, 64)
    if model_layout:
        q, k, v = mla_model_layout(q, k, v)
        assert v.stride(2) == 128 * KV and v.data_ptr() % 128 == 0
    out = check_flash(q, k, v, causal, window, "wgmma")
    if model_layout:
        from repro_torch.kernels import flash_attention as fa

        assert torch.equal(out, fa.flash_attention(
            *(x.contiguous() for x in (q, k, v)), causal=causal,
            window=window))


@pytest.mark.cuda
def test_flash_other_16_bit_shapes_take_mma_sync(cuda):
    """hd 96 / vd 64 (MLA) read 2 bytes off 16, hd == vd off {64, 128},
    and a 16-byte-aligned shape read through rows of 136 elements with the
    base 2 bytes in."""
    q, k, v = flash_inputs(cuda, torch.bfloat16, 1, 3, 1, 70, 130, 96, 64)
    vp = torch.zeros((1, 1, 130, 72), dtype=v.dtype, device=cuda)
    vp[..., 1:65] = v
    check_flash(q, k, vp[..., 1:65], False, None, "mma")
    q, k, v = flash_inputs(cuda, torch.bfloat16, 2, 4, 2, 77, 77, 32)
    check_flash(q, k, v, True, None, "mma")
    q, k, v = flash_inputs(cuda, torch.bfloat16, 1, 4, 2, 96, 96, 128)
    qp = torch.zeros((1, 4, 96, 136), dtype=q.dtype, device=cuda)
    qp[..., 1:129] = q
    check_flash(qp[..., 1:129], k, v, True, None, "mma")


@pytest.mark.cuda
def test_flash_attention_takes_strided_views(cuda):
    """The model hands over (B, S, H, hd) transposed to (B, H, S, hd)."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = flash_inputs(cuda, torch.bfloat16, 2, 4, 2, 96, 96, 64)
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    assert not qt.is_contiguous()
    assert torch.equal(fa.flash_attention(qt, kt, vt),
                       fa.flash_attention(q, k, v))
    # rows of 34 elements (68 bytes): not 16-byte aligned, so the mma.sync
    # body loads its tiles element by element instead of by 16-byte copies;
    # the arithmetic is the same. At hd 32 both layouts take mma.sync (at
    # hd 64 the aligned one takes the wgmma body, the padded one mma.sync).
    q32, k32, v32 = flash_inputs(cuda, torch.bfloat16, 2, 4, 2, 96, 96, 32)
    qp, kp, vp = (torch.zeros(*x.shape[:3], 34, dtype=x.dtype,
                              device=x.device) for x in (q32, k32, v32))
    for dst, src in ((qp, q32), (kp, k32), (vp, v32)):
        dst[..., :32] = src
    padded = (qp[..., :32], kp[..., :32], vp[..., :32])
    assert fa.body(*padded) == fa.body(q32, k32, v32) == "mma"
    assert torch.equal(fa.flash_attention(*padded),
                       fa.flash_attention(q32, k32, v32))
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), k, v)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :1].expand(2, 3, 96, 64), v)
    with pytest.raises(ValueError):
        fa.flash_attention(q.cpu(), k, v)
    # 16-bit inputs run on the tensor cores only: hd % 16 == 0, even vd <= 128
    q24, k24, v24 = flash_inputs(cuda, torch.bfloat16, 1, 2, 2, 64, 64, 24)
    with pytest.raises(ValueError):
        fa.flash_attention(q24, k24, v24)
    q64, k64, v160 = flash_inputs(cuda, torch.bfloat16, 1, 2, 2, 64, 64, 64,
                                  160)
    with pytest.raises(ValueError):
        fa.flash_attention(q64, k64, v160)
    # float32 takes both shapes
    fa.flash_attention(q24.float(), k24.float(), v24.float())
    fa.flash_attention(q64.float(), k64.float(), v160.float())


# the attentions of the serving options at reduced sizes, as the model
# hands them over ((B, S, heads, hd) transposed): MLA's hd 96 / vd 64 (v a
# column slice of the decompressed K/V), the encoder's and the
# cross-attention's non-causal T of 300 (not a multiple of the 128-key
# tile), a decode step's cross-attention (S = 1) and llava's causal GQA 7:1
# over a ragged S, all on wgmma. (B, H, KV, S, T, hd, vd, causal, body)
SERVED_OPTION_CASES = {
    "mla": (2, 4, 4, 200, 200, 96, 64, True, "wgmma"),
    "encoder": (2, 4, 4, 300, 300, 64, 64, False, "wgmma"),
    "cross": (2, 4, 4, 70, 300, 64, 64, False, "wgmma"),
    "cross-decode": (2, 4, 4, 1, 300, 64, 64, False, "wgmma"),
    "llava": (1, 7, 1, 333, 333, 128, 128, True, "wgmma"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SERVED_OPTION_CASES))
def test_flash_served_option_shapes_match_plain_version(cuda, case):
    B, H, KV, S, T, hd, vd, causal, body = SERVED_OPTION_CASES[case]
    q, k, v = flash_inputs(cuda, torch.bfloat16, B, H, KV, S, T, hd, vd)
    q, k = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k))
    nope = 64 if case == "mla" else 0
    # MLA's v: the last vd columns of the decompressed (k_nope | v) rows
    kv = torch.cat([torch.zeros_like(v[..., :1]).expand(
        *v.shape[:3], nope), v], -1)
    v = kv.transpose(1, 2).contiguous().transpose(1, 2)[..., nope:]
    check_flash(q, k, v, causal, None, body)


def whisper_cut():
    """Reduced whisper-large-v3 with two heads of 64 (the served head
    width) so that its bf16 attentions take the wgmma body."""
    from repro_torch.configs import get_config

    return get_config("whisper-large-v3").reduced().replace(
        n_heads=2, kv_heads=2, head_dim=64)


def whisper_run(cfg, device, cross_cache, feed=None, B=2, P=24, steps=3):
    """Prefill and `steps` decode steps, frames in every step's extras or
    in `prepare_cross_cache` once, each step fed the greedy token or the
    one `feed` gives. Returns ([logits], [fed tokens], the flash launches
    of [prepare, prefill, each step])."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as tt

    cfg = cfg.replace(cross_kv_cache=cross_cache)
    model = tt.init_model(cfg, 0, "cpu").to(device)
    rng = np.random.default_rng(3)
    frames = torch.tensor(rng.standard_normal(
        (B, cfg.encoder_ctx, cfg.d_model)) * 0.1, dtype=torch.float32,
        device=device)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (B, P)),
                        device=device)
    cache = tt.init_cache(cfg, B, P + steps, device)
    fa.reset_launches()
    extras = None
    if cross_cache:
        tt.prepare_cross_cache(model, cfg, cache, frames)
        batch = {"tokens": toks}
    else:
        extras = {"frame_embeds": frames}
        batch = {"tokens": toks, **extras}
    launches = [fa.flash_attention.launches]
    logits, cache = tt.prefill(model, cfg, batch, cache)
    launches.append(fa.flash_attention.launches - sum(launches))
    out, fed = [logits[:, -1].float().cpu()], []
    for i in range(steps):
        fed.append(out[-1].argmax(-1) if feed is None else feed[i])
        d, cache = tt.serve_step(model, cfg, cache, fed[i].to(device), P + i,
                                 extras)
        launches.append(fa.flash_attention.launches - sum(launches))
        out.append(d.float().cpu())
    return out, fed, launches


@pytest.mark.cuda
@pytest.mark.parametrize("cross_cache", [False, True])
def test_whisper_on_the_card_matches_the_cpu(cuda, cross_cache):
    """Reduced whisper in float32, both cross-attention paths: the card's
    logits (the flash kernel in the encoder, the prefill and, with frames
    in every step, each decode step's encoder and cross-attention) equal
    the CPU's to 1e-4, each step fed the CPU's greedy token."""
    cfg = whisper_cut().replace(dtype="float32")
    cpu, fed, n_cpu = whisper_run(cfg, "cpu", cross_cache)
    card, _, n = whisper_run(cfg, cuda, cross_cache, feed=fed)
    E, L = cfg.encoder_layers, cfg.n_layers
    if cross_cache:   # the encoder once at admission, then self-attention
        assert n == [E, L, 0, 0, 0]
    else:             # the encoder and the cross-attention in every step
        assert n == [0, E + 2 * L, E + L, E + L, E + L]
    assert not any(n_cpu)
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_whisper_cross_paths_agree_on_the_card_in_bf16(cuda):
    """bf16 at the served head width: every flash launch on wgmma, and on
    the same tokens the cross-cache path's logits match the frames path's
    within bf16's rounding of the two (its plain attention over cached K/V
    rounds P to bf16 where the kernel's P V does too, but at other
    points), relative to the largest logit as chip_smoke's hand-over."""
    from repro_torch.kernels import flash_attention as fa

    cfg = whisper_cut()
    a, fed, _ = whisper_run(cfg, cuda, False)
    by_body = dict(fa.flash_attention.launches_by_body)
    b, _, _ = whisper_run(cfg, cuda, True, feed=fed)
    assert by_body["mma"] == by_body["simt"] == 0 and by_body["wgmma"] > 0
    assert fa.flash_attention.launches_by_body["wgmma"] \
        == fa.flash_attention.launches > 0
    for x, y in zip(a, b):
        assert float((x - y).abs().max()) <= 5e-2 * float(y.abs().max())


def rwkv_inputs(device, B, T, H, K, strong=False, seed=2):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, T, H, K)) * 0.5
    k = rng.standard_normal((B, T, H, K)) * 0.5
    v = rng.standard_normal((B, T, H, K))
    logw = np.full((B, T, H, K), -8.0) if strong \
        else -np.exp(rng.standard_normal((B, T, H, K)) * 0.5 - 0.5)
    u = rng.standard_normal((H, K)) * 0.3
    return tuple(torch.tensor(x, dtype=torch.float32, device=device)
                 for x in (r, k, v, logw, u))


@pytest.mark.cuda
@pytest.mark.parametrize("B, T, H, K, chunk, strong", [
    (1, 64, 2, 32, 32, False),
    (2, 128, 4, 64, 64, False),
    (1, 128, 2, 32, 64, True),      # log w = -8: near-total forgetting
    (2, 100, 3, 32, 16, False),     # ragged T
    (1, 200, 2, 64, 64, False),
])
def test_rwkv6_scan_matches_plain_version(cuda, B, T, H, K, chunk, strong):
    from repro_torch.kernels import rwkv6_scan as rw

    xs = rwkv_inputs(cuda, B, T, H, K, strong)
    launches = rw.rwkv6_scan.launches
    o, S = rw.rwkv6_scan(*xs, chunk=chunk)
    o2, S2 = rw.rwkv6_scan(*xs, chunk=chunk)
    po, pS = rw.rwkv6_scan_ref(*xs, chunk=chunk)
    torch.cuda.synchronize()
    assert rw.rwkv6_scan.launches == launches + 2
    assert torch.equal(o, o2) and torch.equal(S, S2)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(S).all())
    torch.testing.assert_close(o, po, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(S, pS, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("K", [16, 32, 64])
@pytest.mark.parametrize("strong", [False, True])
def test_rwkv6_scan_every_chunk_and_head_size(cuda, chunk, K, strong):
    """Both passes at every chunk and K the kernel is built for, a ragged T
    (and log w = -8): output and final state within 1e-4 (1 + |plain|),
    two calls bitwise equal, each pass launched once per call."""
    from repro_torch.kernels import rwkv6_scan as rw

    xs = rwkv_inputs(cuda, 2, 150, 3, K, strong)
    by_pass = dict(rw.rwkv6_scan.launches_by_pass)
    o, S = rw.rwkv6_scan(*xs, chunk=chunk)
    o2, S2 = rw.rwkv6_scan(*xs, chunk=chunk)
    po, pS = rw.rwkv6_scan_ref(*xs, chunk=chunk)
    torch.cuda.synchronize()
    assert rw.rwkv6_scan.launches_by_pass == {
        p: n + 2 for p, n in by_pass.items()}
    assert torch.equal(o, o2) and torch.equal(S, S2)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(S).all())
    assert float(((o - po).abs() - 1e-4 * (1 + po.abs())).max()) <= 0
    assert float(((S - pS).abs() - 1e-4 * (1 + pS.abs())).max()) <= 0


@pytest.mark.cuda
def test_rwkv6_scan_rejects_bad_inputs(cuda):
    from repro_torch.kernels import rwkv6_scan as rw

    r, k, v, lw, u = rwkv_inputs(cuda, 1, 64, 2, 32)
    with pytest.raises(TypeError):
        rw.rwkv6_scan(r.double(), k, v, lw, u)
    with pytest.raises(ValueError):
        rw.rwkv6_scan(r, k, v, lw, u, chunk=48)
    with pytest.raises(ValueError):
        rw.rwkv6_scan(r, k[:, :32], v, lw, u)
    with pytest.raises(ValueError):
        rw.rwkv6_scan(r.cpu(), k, v, lw, u)


def mamba_inputs(device, B, T, D, N, dt_max=None, seed=4):
    """dt = softplus(z - 1) (or uniform up to dt_max), A = -(1..N) as the
    model's a_log gives it, and Bt, Ct as the two halves of one (B, T, 2N)
    tensor, the strided views the model passes."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, D)) - 1)) \
        if dt_max is None else rng.uniform(0.01, dt_max, (B, T, D))
    A = -np.broadcast_to(np.arange(1.0, N + 1), (D, N))
    bc = rng.standard_normal((B, T, 2 * N)) * 0.5
    x = rng.standard_normal((B, T, D))
    dt, A, bc, x = (torch.tensor(np.ascontiguousarray(a),
                                 dtype=torch.float32, device=device)
                    for a in (dt, A, bc, x))
    Bt, Ct = bc.chunk(2, -1)
    return dt, A, Bt, Ct, x


@pytest.mark.cuda
@pytest.mark.parametrize("B, T, D, N, dt_max", [
    (1, 64, 128, 8, None),       # tests/test_kernels.py's shapes
    (2, 128, 256, 16, None),
    (2, 100, 50, 16, None),      # ragged T and D
    (1, 37, 33, 8, None),
    (2, 1, 16, 16, None),        # one step
    (1, 200, 64, 16, 5.0),       # strong decay: dt A down to -80
    (4, 300, 1000, 16, None),
])
def test_mamba_scan_matches_plain_version(cuda, B, T, D, N, dt_max):
    from repro_torch.kernels import mamba_scan as ms

    xs = mamba_inputs(cuda, B, T, D, N, dt_max)
    launches = ms.mamba_scan.launches
    y, h = ms.mamba_scan(*xs)
    y2, h2 = ms.mamba_scan(*xs)
    py, ph = ms.mamba_scan_ref(*xs)
    torch.cuda.synchronize()
    assert ms.mamba_scan.launches == launches + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y, py, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, ph, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("B, T, D, pad", [
    (2, 1, 50, 0),        # one step; D not a multiple of 4 (4-byte copies)
    (1, 13, 65, 0),       # T not a multiple of the 16-step tile, D of 128
    (2, 100, 130, 2),     # strided dt and x (rows of 132: 16-byte copies)
    (1, 29, 1001, 3),     # rows of 1004: a last copy of one channel
    (3, 64, 256, 0),      # whole tiles and blocks
])
def test_mamba_scan_ragged_tiles_and_blocks(cuda, B, T, D, pad, N):
    """dt and x as views of (B, T, D + pad) tensors; y and the final state
    against the plain version, bitwise repeatable and the same on
    contiguous Bt / Ct."""
    from repro_torch.kernels import mamba_scan as ms

    dt, A, Bt, Ct, x = mamba_inputs(cuda, B, T, D + pad, N)
    dt, x, A = dt[..., :D], x[..., :D], A[:D].contiguous()
    launches = ms.mamba_scan.launches
    y, h = ms.mamba_scan(dt, A, Bt, Ct, x)
    y2, h2 = ms.mamba_scan(dt, A, Bt, Ct, x)
    y3, h3 = ms.mamba_scan(dt, A, Bt.contiguous(), Ct.contiguous(), x)
    py, ph = ms.mamba_scan_ref(dt, A, Bt, Ct, x)
    torch.cuda.synchronize()
    assert ms.mamba_scan.launches == launches + 3
    assert y.shape == (B, T, D) and h.shape == (B, D, N)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert torch.equal(y, y3) and torch.equal(h, h3)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y, py, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, ph, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_mamba_scan_rejects_bad_inputs(cuda):
    from repro_torch.kernels import mamba_scan as ms

    dt, A, Bt, Ct, x = mamba_inputs(cuda, 1, 64, 32, 16)
    with pytest.raises(TypeError):
        ms.mamba_scan(dt.double(), A, Bt, Ct, x)
    with pytest.raises(ValueError):               # N = 4 is not built
        ms.mamba_scan(dt, A[:, :4].contiguous(), Bt[..., :4], Ct[..., :4], x)
    with pytest.raises(ValueError):
        ms.mamba_scan(dt.cpu(), A, Bt, Ct, x)
    with pytest.raises(ValueError):               # T of dt and x differ
        ms.mamba_scan(dt[:, :32], A, Bt, Ct, x)
    with pytest.raises(ValueError):               # A is (N, D)
        ms.mamba_scan(dt, A.t(), Bt, Ct, x)
    with pytest.raises(ValueError):               # x's last dim strided
        ms.mamba_scan(dt, A, Bt, Ct,
                      x.transpose(1, 2).contiguous().transpose(1, 2))


# ---------------------------------------------------------------------------
# the region serving stack on the card: the CUDA-only pieces
# ---------------------------------------------------------------------------

def serve_requests(device, depth=2):
    """Four small float64 requests (two buckets) through a RegionPipeline
    solving on `device`; returns (the dispatched batches, the responses)."""
    import repro_torch as rt

    pipe = rt.RegionPipeline(rt.Weights(0.5, 0.5, 1.0), cells_per_batch=2,
                             min_bucket=8, spec=rt.SolverSpec(max_iters=6),
                             max_in_flight=depth, device=device)
    for cid, n in enumerate((6, 7, 12, 14)):
        sysp = rt.make_system(40 + cid, n, device="cpu", dtype=torch.float64)
        pipe.submit(rt.AllocationRequest(cell_id=cid, sys=sysp))
    batches = pipe.pump(force=True)
    return batches, pipe.drain()


@pytest.mark.cuda
def test_in_flight_batch_holds_a_cuda_event(cuda):
    """A batch dispatched on the card holds its result tensors there and a
    CUDA event recorded after the solve; materializing copies to the
    host. The card's responses match the CPU pipeline's (float64)."""
    batches, out = serve_requests(cuda)
    assert len(batches) == 2
    for b in batches:
        assert isinstance(b.event, torch.cuda.Event)
        assert b.result.allocation.bandwidth.is_cuda
        assert b.plan.sys_batch.gain.is_cuda and b.materialized
        assert b.event.query()
    _, ref = serve_requests("cpu")
    assert [r.cell_id for r in out] == [r.cell_id for r in ref]
    for a, b in zip(out, ref):
        assert a.allocation.bandwidth.device.type == "cpu"
        assert (a.iters, a.warm, a.bucket) == (b.iters, b.warm, b.bucket)
        assert abs(a.objective - b.objective) <= 1e-8 * abs(b.objective)


@pytest.mark.cuda
def test_spans_open_nvtx_ranges_and_profiler_ranges(cuda):
    """On a CUDA build a span pushes an NVTX range (no error) and names a
    record_function range that holds the card's launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.obs import recorder

    assert recorder._NVTX
    x = torch.ones(256, 256, device=cuda)
    with obs.recording(obs.MemoryRecorder()) as rec:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with obs.span("cuda_span"):
                (x @ x).sum()
            torch.cuda.synchronize()
    assert [e["name"] for e in rec.events] == ["cuda_span"]
    assert "cuda_span" in {e.name for e in prof.events()}


@pytest.mark.cuda
def test_default_region_mesh_holds_every_card(cuda):
    """region_mesh() holds every visible CUDA device; a mesh solve on it
    equals the fleet solve bit for bit (one card: one shard)."""
    import repro_torch as rt

    mesh = rt.region_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i)
                                 for i in range(torch.cuda.device_count()))
    fleet = make_fleet(3, 5, 64, device=cuda, dtype=torch.float32)
    w, spec = rt.Weights(0.5, 0.5, 1.0), rt.SolverSpec(max_iters=6)
    base = rt.solve(rt.Problem(system=fleet, weights=w), spec)
    for lockstep in (False, True):
        reg = rt.solve(rt.Problem(system=fleet, weights=w, mesh=mesh),
                       spec.replace(lockstep=lockstep))
        for f in ("bandwidth", "power", "freq", "resolution"):
            assert torch.equal(getattr(reg.allocation, f).cpu(),
                               getattr(base.allocation, f).cpu()), f
        assert torch.equal(reg.iters.cpu(), base.iters.cpu())
        assert reg.stats["mesh_devices"] == mesh.size


@pytest.mark.cuda
def test_solve_assoc_on_the_card_outer0_is_the_fleet_solve(cuda):
    """Association on a small region on the card: outer_iters=0 is the
    fleet solve of the nearest association, bit for bit, and a full run
    keeps the partition and a strictly decreasing objective."""
    import repro_torch as rt
    from repro_torch.assoc import (AssocConfig, make_multicell,
                                   nearest_assignment)

    sysb = make_multicell(5, 4, 256, device=cuda, dtype=torch.float32,
                          bandwidth_total=[20e6 * 64 / 50 * (1 + c)
                                           for c in range(4)])
    w, spec = rt.Weights(0.5, 0.5, 5.0), rt.SolverSpec(max_iters=6, tol=1e-4)
    r0 = rt.solve(rt.Problem(system=sysb, weights=w,
                             assoc=AssocConfig(outer_iters=0)), spec)
    near = nearest_assignment(sysb, np.full(4, 256))
    direct = rt.solve(rt.Problem(system=sysb.with_assignment(near),
                                 weights=w), spec)
    assert np.array_equal(r0.assignment, near)
    for f in ("bandwidth", "power", "freq", "resolution", "T"):
        assert torch.equal(getattr(r0.fleet.allocation, f),
                           getattr(direct.allocation, f)), f
    sp1_sweep.sp1_lambda_sum.launches = 0
    res = rt.solve(rt.Problem(system=sysb, weights=w,
                              assoc=AssocConfig(outer_iters=4)), spec)
    assert sp1_sweep.sp1_lambda_sum.launches > 0
    assert (res.assignment >= 0).all()
    assert all(b < a for a, b in zip(res.objectives, res.objectives[1:]))


@pytest.mark.cuda
def test_local_train_twice_on_the_card_is_bit_identical(cuda):
    """Two local_train runs on the same inputs give the same bits at
    every dataset resolution of the paper's client model (deterministic
    algorithms inside fl.client), and the caller's mode comes back."""
    from repro_torch.fl import local_train, make_federated_dataset, render
    from repro_torch.models.cnn import init_cnn

    ds = make_federated_dataset(0, n_clients=2, per_client=128,
                                num_classes=8, base_resolution=32,
                                device=cuda)
    params = init_cnn(1, num_classes=8, device=cuda)
    assert not torch.are_deterministic_algorithms_enabled()
    for res in (8, 16, 24, 32):
        imgs = render(ds.images[0], res)
        a, la = local_train(params, imgs, ds.labels[0], 0.05, 5)
        b, lb = local_train(params, imgs, ds.labels[0], 0.05, 5)
        assert torch.equal(la, lb) and bool(torch.isfinite(la)), res
        for layer in a:
            for leaf in a[layer]:
                assert torch.equal(a[layer][leaf], b[layer][leaf]), \
                    (res, layer, leaf)
    assert not torch.are_deterministic_algorithms_enabled()


# ---------------------------------------------------------------------------
# training: the LM kernels' Functions and a reduced train step
# ---------------------------------------------------------------------------

def function_gaps(fn, plain, inputs):
    """(output gap, [input gradient gaps]) of a kernels.ops Function (the
    kernel forward, the training formulation's backward) against autograd
    through the plain version, each relative to the plain one's largest
    magnitude, on one random cotangent."""
    gen = torch.Generator(device=inputs[0].device).manual_seed(3)
    res = []
    for f in (fn, plain):
        xs = [x.detach().clone().requires_grad_(True) for x in inputs]
        out = f(*xs)
        out = out[0] if isinstance(out, tuple) else out
        if not res:
            co = torch.randn(out.shape, generator=gen,
                             device=out.device).to(out.dtype)
        res.append((out.detach(), torch.autograd.grad(out, xs, co)))

    def gap(a, b):
        return float((a.float() - b.float()).abs().max()) / float(
            b.float().abs().max())

    (o1, g1), (o2, g2) = res
    return gap(o1, o2), [gap(a, b) for a, b in zip(g1, g2)]


# bf16 rounds the formulation's scores and probabilities (and the kernel's
# P) where the plain version keeps float32; float32 sums in other orders
TRAIN_FN_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S, window", [(512, None), (300, 128), (77, None),
                                       (2048, None), (2048, 128)])
def test_flash_function_gradients_match_plain_on_the_card(cuda, dtype, S,
                                                          window):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.models.attention import _chunked_attn_heads_first

    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((1, 12, S, 128), generator=gen, device=cuda).to(dtype)
    k = torch.randn((1, 2, S, 128), generator=gen, device=cuda).to(dtype)
    v = torch.randn((1, 2, S, 128), generator=gen, device=cuda).to(dtype)
    kw = dict(causal=True, window=window, scale=128 ** -0.5)
    before = fa.flash_attention.launches
    out_gap, grad_gaps = function_gaps(
        lambda *a: kops.flash_attention(
            *a, backward=_chunked_attn_heads_first, **kw),
        lambda *a: fa.flash_attention_ref(*a, **kw), (q, k, v))
    assert fa.flash_attention.launches == before + 1   # the forward only
    assert max([out_gap, *grad_gaps]) <= TRAIN_FN_TOL[dtype], \
        (out_gap, grad_gaps)


@pytest.mark.cuda
@pytest.mark.parametrize("T, chunk", [(300, 64), (77, 16), (300, 16),
                                      (2048, 64)])
def test_rwkv6_function_gradients_match_plain_on_the_card(cuda, T, chunk):
    """(300, 16) and (2048, 64) run 19 and 32 chunks: more than the 8 that
    `_wkv_chunked` forms at once, so its groups are joined."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.models.ssm import _wkv_chunked

    gen = torch.Generator(device=cuda).manual_seed(2)
    r, k, v = (torch.randn((2, T, 4, 64), generator=gen, device=cuda) * 0.5
               for _ in range(3))
    logw = -torch.exp(torch.randn((2, T, 4, 64), generator=gen,
                                  device=cuda) * 0.5 - 0.5)
    u = torch.randn((4, 64), generator=gen, device=cuda) * 0.3
    before = rw.rwkv6_scan.launches
    out_gap, grad_gaps = function_gaps(
        lambda *a: kops.rwkv6_scan(*a, chunk=chunk, backward=_wkv_chunked),
        lambda *a: rw.rwkv6_scan_ref(*a, chunk=chunk), (r, k, v, logw, u))
    assert rw.rwkv6_scan.launches == before + 1
    assert max([out_gap, *grad_gaps]) <= TRAIN_FN_TOL[torch.float32], \
        (out_gap, grad_gaps)


@pytest.mark.cuda
@pytest.mark.parametrize("T, chunk", [(300, 256), (50, 16)])
def test_mamba_function_gradients_match_plain_on_the_card(cuda, T, chunk):
    import functools

    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops as kops
    from repro_torch.models.ssm import _ssm_chunked

    gen = torch.Generator(device=cuda).manual_seed(4)
    D, N = 256, 16
    dt = torch.nn.functional.softplus(
        torch.randn((2, T, D), generator=gen, device=cuda) - 1)
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device=cuda).expand(D, N).contiguous()
    Bt, Ct = (torch.randn((2, T, N), generator=gen, device=cuda) * 0.5
              for _ in range(2))
    x = torch.randn((2, T, D), generator=gen, device=cuda)
    before = ms.mamba_scan.launches
    out_gap, grad_gaps = function_gaps(
        lambda *a: kops.mamba_scan(*a, backward=functools.partial(
            _ssm_chunked, chunk=chunk)),
        ms.mamba_scan_ref, (dt, A, Bt, Ct, x))
    assert ms.mamba_scan.launches == before + 1
    assert max([out_gap, *grad_gaps]) <= TRAIN_FN_TOL[torch.float32], \
        (out_gap, grad_gaps)


@pytest.mark.cuda
@pytest.mark.parametrize("arch, kw", [("internlm2-20b", dict(kv_heads=2)),
                                      ("rwkv6-1.6b", {}),
                                      ("jamba-1.5-large-398b",
                                       dict(kv_heads=2))])
def test_reduced_train_step_on_the_card_matches_the_cpu(cuda, arch, kw):
    """One float32 train step (AdamW lr 1e-3, clip 1.0) from the same
    weights and tokens: loss and grad_norm to 1e-4, every gradient to 1e-4
    of its largest magnitude, with TF32 off."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import AdamW

    cfg = get_config(arch).reduced().replace(dtype="float32", **kw)
    base = init_model(cfg, 0, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(5))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", cuda):
            model = copy.deepcopy(base).to(dev)
            step, opt = make_train_step(cfg, AdamW(lr=1e-3))
            grads = {}
            before = kops.launch_counts()
            _, _, m = step(model, opt.init(dict(model.named_parameters())),
                           {"tokens": toks.to(dev)}, grads)
            launched = sum(n - before[k]
                           for k, n in kops.launch_counts().items())
            out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                             {n: g.cpu() for n, g in grads.items()},
                             launched)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (l0, n0, g0, k0), (l1, n1, g1, k1) = out["cpu"], out[str(cuda)]
    # one kernel launch a layer on the card (remat is off reduced), none on
    # the CPU
    assert k0 == 0 and k1 == cfg.n_periods * sum(
        kind in ("attn", "attn_moe", "rwkv", "mamba", "mamba_moe")
        for kind in cfg.block_pattern)
    assert abs(l1 - l0) <= 1e-4 * abs(l0)
    assert abs(n1 - n0) <= 1e-4 * abs(n0)
    for name, g in g0.items():
        assert float((g1[name] - g).abs().max()) <= \
            1e-4 * float(g.abs().max()) + 1e-12, name


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["flash_attention", "rwkv6_scan",
                                "mamba_scan"])
def test_custom_op_launches_the_kernel_and_counts_its_flops(cuda, op):
    """Each LM kernel's custom op, on CUDA tensors, is its hand-written
    kernel: the same bits as the wrapper (one launch each), FlopCounterMode
    counts its formula, and the fake of the same inputs on "meta" gives the
    card's shapes and dtypes."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import rwkv6_scan as rw

    if op == "flash_attention":
        B, H, KV, S, hd = 2, 8, 2, 300, 128
        xs = flash_inputs(cuda, torch.bfloat16, B, H, KV, S, S, hd)
        args, wrapper = (*xs, True, 128, None), fa.flash_attention
        direct = (wrapper(*xs, causal=True, window=128),)
        flops = kops.flash_attention_flops(B, H, S, S, hd, hd, True, 128)
        call = kops.flash_attention_op
    elif op == "rwkv6_scan":
        B, T, H, K = 2, 100, 3, 32
        xs = rwkv_inputs(cuda, B, T, H, K)
        args, wrapper = (*xs, 16), rw.rwkv6_scan
        direct = wrapper(*xs, chunk=16)
        flops = kops.rwkv6_scan_flops(B, T, H, K)
        call = kops.rwkv6_scan_op
    else:
        B, T, D, N = 2, 100, 50, 16
        xs = mamba_inputs(cuda, B, T, D, N)
        args, wrapper = xs, ms.mamba_scan
        direct = wrapper(*xs)
        flops = kops.mamba_scan_flops(B, T, D, N)
        call = kops.mamba_scan_op
    launches = wrapper.launches
    with FlopCounterMode(display=False) as fc:
        out = call(*args)
    torch.cuda.synchronize()
    out = out if isinstance(out, tuple) else (out,)
    assert wrapper.launches == launches + 1
    assert fc.get_total_flops() == flops
    assert all(torch.equal(a, b) for a, b in zip(out, direct))
    fake = call(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                  for a in args))
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(f.shape, f.dtype) for f in fake] == \
        [(o.shape, o.dtype) for o in out]
    assert wrapper.launches == launches + 1
