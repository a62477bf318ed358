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


@pytest.mark.cuda
def test_flash_other_16_bit_shapes_take_mma_sync(cuda):
    """hd 96 / vd 64 (MLA), hd == vd off {64, 128}, and a 16-byte-aligned
    shape read through rows of 136 elements with the base 2 bytes in."""
    q, k, v = flash_inputs(cuda, torch.bfloat16, 1, 3, 1, 70, 130, 96, 64)
    check_flash(q, k, v, False, None, "mma")
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
