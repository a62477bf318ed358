"""The design of the port's Hopper kernels, checked on the CPU.

* `flash_attention.body`, the function that picks the CUDA body for the
  given inputs, on CPU tensors (it reads only dtypes, shapes, strides and
  data pointers; no kernel runs): the wgmma/TMA body for the served
  prefills, contiguous or as the model's (B, S, H, hd).transpose(1, 2)
  views, MLA's q/k 96 with v 64 included (v a column slice of the
  decompressed K/V rows); mma.sync for the other 16-bit shapes and for
  views off 16 bytes; the SIMT body for float32.
* The two-pass decomposition of `csrc/rwkv6_scan.cu`, rendered in plain
  torch here in float64 (a state pass that keeps the state entering each
  chunk, then an output pass per chunk that builds A from pairwise
  exponentials inside 16-row sub-blocks and from three factors across
  them), against the JAX package's sequential recurrence
  `repro.kernels.ref.rwkv6_ref` (which computes in float32: 1e-5 relative
  and absolute) and against the same recurrence in float64 (the
  decomposition is exact: 1e-10).
* The early exit of `csrc/waterfill.cu`'s Halley loop, replayed in plain
  torch (`waterfill.lambertw_early_exit`: each lane stops at the first
  iterate that repeats the one or the two before it bit for bit, a fixed
  point or a two-cycle), against the 24 fixed steps
  of `_lambertw_vec`: the same bits in float32 and float64, on a reduced
  Theorem-2 region cell, at the branch point (q in [1e-6, 1e-2]) and at
  large q (z > 3), with at most 24 steps a lane.
* The register form of `csrc/mamba_scan.cu` (one channel's N states
  stepped in order of t, the decay as exp2(dt (A log2 e)), y summed over n
  from 0 up), rendered in plain torch float32, against the JAX package's
  `repro.kernels.ref.mamba_scan_ref` and the port's plain version, to
  1e-4 (1 + |plain|), with the strong decay and ragged T and D.
* The hoisted form of `csrc/sp1_sweep.cu` (per-cell and per-device terms
  formed once, the lambda = 0 candidate's makespan per device, the
  unattainable floor first), rendered in torch, against
  `lambda_of_T_linear` bit for bit in float32 and float64: a reduced fleet
  on the three sweep rounds' T grids, w1 = 0, q = tt = 0 lanes,
  unattainable and NaN deadlines. Its sums in the kernel's order (warp
  butterfly, warps, blocks) stay within chip_smoke's tolerances of
  `sp1_lambda_sum_ref` and pick the same bracket. The kernel's float32
  shortcuts (reciprocal products, lg2/ex2, rsqrt) are held on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ref as jref

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import waterfill as wf
from test_torch_cuda import mamba_inputs

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


def mla_tensors(B, H, S, dtype=torch.bfloat16, model_layout=False):
    """MLA's q, k (q/k width 96) and v (width 64), contiguous or as the
    model hands them over: q and k (B, S, H, 96) `torch.cat` results and v
    the last 64 columns of the decompressed (k_nope | v) rows of 128, each
    transposed to (B, H, S, width)."""
    if not model_layout:
        return attn_tensors(B, H, H, S, 96, 64, dtype=dtype)
    kv = torch.zeros((B, S, H, 128), dtype=dtype)
    return (torch.zeros((B, S, H, 96), dtype=dtype).transpose(1, 2),
            torch.zeros((B, S, H, 96), dtype=dtype).transpose(1, 2),
            kv[..., 64:].transpose(1, 2))


@pytest.mark.parametrize("model_layout", [False, True])
def test_mla_takes_the_wgmma_body(model_layout):
    cfg = get_config("minicpm3-4b")
    assert (cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim) == (96, 64)
    q, k, v = mla_tensors(2, cfg.n_heads, 64, model_layout=model_layout)
    assert v.is_contiguous() != model_layout
    assert fa.body(q, k, v) == "wgmma"
    assert fa.body(q.half(), k.half(), v.half()) == "wgmma"


def test_mla_off_16_bytes_takes_mma_sync():
    # v read 2 bytes into the (k_nope | v) rows, q through rows of 104
    # elements with the base 2 bytes in
    q, k, v = mla_tensors(1, 4, 32, model_layout=True)
    kv = torch.zeros((1, 32, 4, 129), dtype=torch.bfloat16)
    assert fa.body(q, k, kv[..., 65:].transpose(1, 2)) == "mma"
    qp = torch.zeros((1, 4, 32, 104), dtype=torch.bfloat16)
    assert fa.body(qp[..., 1:97], k, v) == "mma"
    assert fa.body(qp[..., :96], k, v) == "wgmma"


@pytest.mark.parametrize("hd, vd", [(32, 32), (96, 96), (128, 64),
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


# ---------------------------------------------------------------------------
# waterfill_gprime: Halley stopped at its bitwise fixed point
# ---------------------------------------------------------------------------

def region_ratios(dtype, n=2048, seed=17):
    """q = mu / j of the Theorem-2 dual search's first sweep over a reduced
    region cell (examples/allocate_fleet.py section 3 at n devices: 20 MHz
    per 50, f = 1 GHz, s = 320, T = 1.2 x the slowest compute time, weights
    (0.5, 0.5, 1.0)), as `core/sp2.py::_thm2_dual_mu` forms it: (1, 128, n)."""
    from repro_torch import make_system
    from repro_torch.core.energy import t_cmp
    from repro_torch.core.sp1 import _cells_view, _geomspace
    from repro_torch.core.sp2 import (G, _clamp_rmin, _thm2_bracket, _thm2_j,
                                      r_min)
    from repro_torch.core.types import Weights

    sysp = make_system(seed, n_devices=n, device="cpu", dtype=torch.float64,
                       bandwidth_total=20e6 * n / 50).to(dtype=dtype)
    shape = sysp.gain.shape
    f = torch.full(shape, 1e9, dtype=dtype)
    s = torch.full(shape, 320.0, dtype=dtype)
    rmin = r_min(sysp, f, s, t_cmp(sysp, f, s).amax(-1, keepdim=True) * 1.2)
    rate0 = G(sysp, torch.broadcast_to(sysp.p_max, shape),
              torch.broadcast_to(sysp.bandwidth_total / n, shape))
    nu = Weights(0.5, 0.5, 1.0).normalized().w1 * sysp.global_rounds / rate0
    b, (nu, rmin) = _cells_view(sysp, nu, rmin)
    rmin = _clamp_rmin(b, rmin)
    j = _thm2_j(b, nu)
    mu = _geomspace(*_thm2_bracket(b, j, rmin), 128)
    return mu[:, :, None] / j[:, None, :]


def halley_ratios(case, dtype):
    if case == "region":
        return region_ratios(dtype)
    if case == "branch_point":
        return torch.logspace(-6, -2, 20000, dtype=torch.float64).to(dtype)
    # z = (q - 1)/e > 3 up to 1e30
    return torch.logspace(np.log10(3 * np.e + 1) + 1e-6, 30, 20000,
                          dtype=torch.float64).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["region", "branch_point", "large_q"])
def test_halley_exit_gives_the_24_step_bits(case, dtype, record_property):
    q = halley_ratios(case, dtype)
    if case == "large_q":
        assert bool((((q - 1) / np.e) > 3).all())
    fixed = wf._lambertw_vec(q)
    w, steps = wf.lambertw_early_exit(q)
    assert w.dtype == dtype and steps.shape == q.shape
    assert torch.equal(wf._bits(w), wf._bits(fixed))
    series = q < 1e-3            # the series value: no Halley step
    assert bool((steps[series] == 0).all())
    assert bool((steps[~series] >= 1).all())
    assert int(steps.max()) <= wf.HALLEY_STEPS
    assert bool(torch.isfinite(w).all())
    if case == "region" and dtype == torch.float32:
        # lanes whose iterates end in a two-cycle of the last bits, not a
        # fixed point: the rule's second test is exercised here
        _, zc, _, w_i = wf._lambertw_seed(q)
        hist = [w_i]
        for _ in range(wf.HALLEY_STEPS):
            hist.append(wf._halley_step(hist[-1], zc))
        last = [wf._bits(h) for h in hist[-3:]]
        assert bool(((last[2] == last[0]) & (last[2] != last[1])).any())
    mean = float(steps.double().mean())
    record_property("halley_steps_mean", mean)
    print(f"{case} {dtype}: {mean:.3f} Halley steps a lane on average, "
          f"at most {int(steps.max())}")


def test_halley_exit_keeps_nan_and_the_cap():
    """A NaN ratio gives the 24-step NaN's bits; a cap of k steps gives the
    k-step W's bits."""
    q = torch.tensor([float("nan"), 0.0, 1e-3, 1.0, 2.5, 1e12])
    for iters in (1, 3, 24):
        w, steps = wf.lambertw_early_exit(q, iters)
        assert torch.equal(wf._bits(w), wf._bits(wf._lambertw_vec(q, iters)))
        assert int(steps.max()) <= iters


# ---------------------------------------------------------------------------
# mamba_scan: a channel's N states in one thread's registers
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634


def mamba_register_form(dt, A, Bt, Ct, x):
    """The kernel's arithmetic per (b, d) channel, all channels at once:
    h[n] <- exp2(dt (A[n] log2 e)) h[n] + (dt B_t[n]) x_t, then
    y_t = h[0] C_t[0] + h[1] C_t[1] + ... in order of n. float32."""
    Bsz, T, D = x.shape
    N = A.shape[1]
    al = A * torch.tensor(LOG2E, dtype=torch.float32)
    h = torch.zeros((Bsz, D, N), dtype=torch.float32)
    ys = []
    for t in range(T):
        dtv, xv = dt[:, t, :, None], x[:, t, :, None]
        a = torch.exp2(dtv * al)
        h = a * h + (dtv * Bt[:, t, None, :]) * xv
        y = h[..., 0] * Ct[:, t, None, 0]
        for n in range(1, N):
            y = y + h[..., n] * Ct[:, t, None, n]
        ys.append(y)
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("B, T, D, N, dt_max", [
    (1, 64, 128, 8, None),
    (2, 37, 33, 8, None),        # ragged T and D
    (1, 100, 50, 16, None),
    (1, 1, 16, 16, None),        # one step
    (1, 200, 64, 16, 5.0),       # strong decay: dt A down to -80
    (2, 45, 70, 16, 5.0),
])
def test_mamba_register_form_matches_references(B, T, D, N, dt_max):
    dt, A, Bt, Ct, x = mamba_inputs("cpu", B, T, D, N, dt_max)
    if dt_max is not None:
        assert float(dt.max() * A.min()) < -75.0
    y, h = mamba_register_form(dt, A, Bt, Ct, x)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    py, ph = ms.mamba_scan_ref(dt, A, Bt, Ct, x)
    jy, jh = jref.mamba_scan_ref(*(jnp.asarray(a.numpy())
                                   for a in (dt, A, Bt, Ct, x)))
    for got, plain in ((y, py), (h, ph), (y, torch.tensor(np.asarray(jy))),
                       (h, torch.tensor(np.asarray(jh)))):
        assert float(((got - plain).abs()
                      - 1e-4 * (1 + plain.abs())).max()) <= 0.0


# ---------------------------------------------------------------------------
# sp1_lambda_sum: per-cell and per-device terms hoisted, fixed-order sums
# ---------------------------------------------------------------------------

def sp1_fleet_inputs(dtype, weights=(0.5, 0.5, 1.0), cells=4, n=2048,
                     seed=31):
    """A reduced fleet (the main path's fleet at C=4, 20 MHz per 50
    devices) at its initial allocation: q, tt (C, N), the kernel's consts
    rows (C, 8), the sweep's target (C, 1) and its T bounds."""
    from repro_torch import make_fleet
    from repro_torch.api.problem import weights_leaf
    from repro_torch.core.accuracy import default_accuracy
    from repro_torch.core.bcd import initial_allocation
    from repro_torch.core.energy import rate
    from repro_torch.core.sp1 import _coeffs, _sp1_bounds, _sweep_consts
    from repro_torch.core.types import Weights

    b = make_fleet(seed, cells, n, device="cpu", dtype=dtype,
                   bandwidth_total=20e6 * n / 50).batched()
    alloc = initial_allocation(b)
    tt = b.bits / torch.clamp_min(rate(b, alloc.bandwidth, alloc.power),
                                  1e-12)
    warr = weights_leaf(Weights(*weights), dtype, b.device, cells=cells)
    w = Weights(warr[:, 0:1], torch.clamp_min(warr[:, 1:2], 1e-9),
                warr[:, 2:3])
    _, q = _coeffs(b, w)
    lam_hi, target, T_lo, T_hi = _sp1_bounds(b, w, q, tt)
    consts = _sweep_consts(b, w, default_accuracy(), lam_hi)
    return q.contiguous(), tt.contiguous(), consts, target, T_lo, T_hi


def sp1_sweep_grids(q, tt, consts, target, T_lo, T_hi):
    """The T grids of the sweep's three rounds, as
    `core/sp1.py::_solve_sp1_sweep_impl` builds them, side by side:
    (C, 3 x 16)."""
    from repro_torch.core.sp1 import (_SWEEP_POINTS, _SWEEP_ROUNDS, _bracket,
                                      _geomspace)
    from repro_torch.kernels import sp1_sweep

    grids, lo, hi = [], T_lo, T_hi
    for _ in range(_SWEEP_ROUNDS):
        grid = _geomspace(lo, hi, _SWEEP_POINTS)
        grids.append(grid)
        lo, hi, _, _ = _bracket(sp1_sweep.sp1_lambda_sum_ref(
            grid.contiguous(), q, tt, consts), target, grid)
    return torch.cat(grids, -1).contiguous()


def sp1_hoisted_form(T_grid, q, tt, consts):
    """lambda_n(T_m) (C, M, N) as `csrc/sp1_sweep.cu` computes it in its
    IEEE form (float64; float32 before its cheaper forms), in torch: each
    term that depends only on the cell is formed at (C, 1, 1) and only on
    the device at (C, 1, N), with the kernel's association order (2 alpha,
    2 alpha F^2, q S^2, 2 q_safe, the floor); the lambda = 0 candidate's
    forward makespan once per device, not per pair; the unattainable floor
    decides first. Returns (lambda, the hoisted lambda = 0 error, the same
    error as the plain version forms it per pair). The cube roots run on a
    (6, C, M, N) stack laid out as `lambda_of_T_linear`'s (row 0 is the
    lambda = 0 candidate and only gives the per-pair error compared
    against), so PyTorch's vectorised and scalar pow paths, whose last bits
    differ, meet the same elements in both."""
    from repro_torch.kernels.sp1_sweep import _cbrt, _clip

    tiny = torch.finfo(q.dtype).tiny
    k3, rhok, f_min, f_max, s_lo, s_hi, lam_hi = (
        consts[:, i, None, None] for i in range(7))
    # per cell
    k3_safe = torch.clamp_min(k3, tiny)
    f6_cell = (rhok / torch.clamp_min(3.0 * k3, tiny)) ** 0.4
    F = (f_min, f_max)
    FF = (f_min * f_min, f_max * f_max)
    SS = (s_lo * s_lo, s_hi * s_hi)
    lam0 = _clip(torch.zeros_like(lam_hi), 0.0, lam_hi)
    f0 = _clip(_cbrt(lam0 / k3_safe), f_min, f_max)
    fs0 = torch.clamp_min(f0, 1e-9)
    fmax_safe = torch.clamp_min(f_max, 1e-9)

    def makespan(lam, f, fs, q, two_alpha):
        psi = two_alpha * (f * f) + 2.0 * lam * q / fs
        s = _clip(rhok / torch.clamp_min(psi, tiny), s_lo, s_hi)
        return q * (s * s) / fs

    # per device
    q, tt = q[:, None, :], tt[:, None, :]
    q_safe = torch.clamp_min(q, tiny)
    two_alpha = 2.0 * (0.5 * k3 * q)
    a2F = [two_alpha * FF[i] for i in range(2)]
    two_q = 2.0 * q_safe
    qSS = [q * SS[i] for i in range(2)]
    floor = qSS[0] / fmax_safe
    mk0 = makespan(lam0, f0, fs0, q, two_alpha)
    # per pair
    t_c = torch.clamp_min(T_grid[:, :, None] - tt, tiny)
    cands = [(rhok / torch.clamp_min(torch.sqrt(t_c * F[i] / q_safe), tiny)
              - a2F[i]) * F[i] / two_q for i in range(2)]
    for i in range(2):
        f = qSS[i] / t_c
        cands.append(k3 * (f * f * f))
    f6 = f6_cell * torch.clamp_min(q * t_c, tiny) ** -0.2
    cands.append(k3 * (f6 * f6 * f6))
    lam = torch.stack(torch.broadcast_tensors(lam0, *cands))
    lam = torch.where(torch.isnan(lam), lam_hi, _clip(lam, 0.0, lam_hi))
    f = _clip(_cbrt(lam / k3_safe), f_min, f_max)
    err = torch.abs(makespan(lam, f, torch.clamp_min(f, 1e-9), q, two_alpha)
                    - t_c)
    err0 = torch.abs(mk0 - t_c)
    err = torch.cat([err0.expand_as(t_c)[None], err[1:]])
    best = err.amin(0)
    near = err <= best * (1.0 + 1e-6) + tiny
    out = torch.where(near, lam, torch.full_like(lam, float("inf"))).amin(0)
    return torch.where(floor > t_c, lam_hi, out), err0, err[0]


def sp1_design_case(case, dtype):
    """(T_grid, q, tt, consts) of each case the hoisted form is held to."""
    weights = (0.0, 1.0, 1.0) if case == "w1_zero" else (0.5, 0.5, 1.0)
    q, tt, consts, target, T_lo, T_hi = sp1_fleet_inputs(dtype, weights)
    grid = sp1_sweep_grids(q, tt, consts, target, T_lo, T_hi)
    if case == "zero_lanes":                 # q = tt = 0: lambda exactly 0
        q, tt = q.clone(), tt.clone()
        q[:, ::5] = 0.0
        tt[:, ::5] = 0.0
    elif case == "unattainable":             # below every floor up to T_lo
        grid = T_lo * torch.logspace(-3, 0, 16, dtype=dtype)
    elif case == "nan":
        grid = grid.clone()
        grid[:, ::3] = float("nan")
    return grid.contiguous(), q, tt, consts


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["fleet", "w1_zero", "zero_lanes",
                                  "unattainable", "nan"])
def test_sp1_hoisted_form_gives_the_plain_bits(case, dtype):
    from repro_torch.kernels import sp1_sweep

    T_grid, q, tt, consts = sp1_design_case(case, dtype)
    lam, err0, err0_per_pair = sp1_hoisted_form(T_grid, q, tt, consts)
    plain = sp1_sweep.lambda_of_T_linear(
        T_grid[:, :, None], q[:, None, :], tt[:, None, :],
        *(consts[:, i, None, None] for i in range(7)))
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(err0.expand_as(err0_per_pair).view(bits),
                       err0_per_pair.view(bits))
    assert torch.equal(lam.view(bits), plain.view(bits))
    lam_hi = consts[:, 6, None, None]
    if case == "zero_lanes":
        assert bool((lam[..., ::5] == 0).all())
    if case == "unattainable":                # the floor decides first
        k = consts[:, :, None, None]
        floor = q[:, None, :] * (k[:, 4] * k[:, 4]) / k[:, 3]
        unmet = floor > torch.clamp_min(T_grid[:, :, None] - tt[:, None, :],
                                        torch.finfo(dtype).tiny)
        assert bool(unmet[:, 0].all())        # 1e-3 T_lo: no device
        assert bool((lam == lam_hi)[unmet].all())
    if case == "nan":                         # no deadline: lambda = inf
        assert bool(torch.isinf(lam[:, ::3]).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [2048, 1500])
def test_sp1_kernel_order_sums_stay_within_tolerance(n, dtype):
    """The terms summed in the kernel's order (`kernel_order_sum`: warp
    butterfly, warps, blocks) against `sp1_lambda_sum_ref`, at
    chip_smoke's tolerances for this kernel, and the same bracket pick on
    every round's grid."""
    from repro_torch.core.sp1 import _bracket
    from repro_torch.kernels import sp1_sweep
    from test_torch_cuda import kernel_order_sum

    q, tt, consts, target, T_lo, T_hi = sp1_fleet_inputs(dtype, n=n)
    grid = sp1_sweep_grids(q, tt, consts, target, T_lo, T_hi)
    lam, _, _ = sp1_hoisted_form(grid, q, tt, consts)
    out = kernel_order_sum(lam)
    plain = sp1_sweep.sp1_lambda_sum_ref(grid, q, tt, consts)
    if dtype == torch.float64:
        scale, tol = plain.abs().clamp_min(torch.finfo(dtype).tiny), 1e-10
    else:
        scale, tol = torch.maximum(plain.abs(), 1e-6 * consts[:, 6:7] * n), \
            1e-4
    assert float(((out - plain).abs() / scale).max()) <= tol
    for r in range(3):
        cols = slice(16 * r, 16 * (r + 1))
        picks = [_bracket(S[:, cols], target, grid[:, cols])[:2]
                 for S in (out, plain)]
        assert all(torch.equal(a, b) for a, b in zip(*picks))
