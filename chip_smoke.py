#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from `src/repro_torch/kernels/csrc`
(one nvcc per source, started together, into build/repro_torch/), then:

  1. prints the card, its power limit, the torch/CUDA versions and the
     build times (and ptxas's register/spill report);
  2. holds each kernel against its plain PyTorch version on the card, at
     the main paths' shapes and at ragged and edge-case ones (float32 and
     float64 for the solver kernels, float32 and bf16 for attention,
     float32 for RWKV6 and the Mamba scan with their final states), checks
     that two launches on the same inputs agree bitwise and that kernel
     and plain sums pick the same bracket; sp1_lambda_sum also on the
     padded pool's zero-data lanes (q = tt = 0 inside N) and an all-zero
     cell, in float32 and float64: each cell's sums against the kernel
     over its non-zero prefix alone, the all-zero cell's exactly 0.0; records which attention body
     (wgmma, mma.sync or SIMT) each case takes, counted per body, and
     checks that the served prefill shapes, also as the model's transposed
     views, take the wgmma body;
  3. drives the main paths through the port's entry points at full width,
     each with every kernel's launch count set to 0 just before and read
     just after:
       - Algorithm 2 through `repro_torch.solve`: the C=64 x N=2048
         float32 fleet, max_iters=8, weights (0.5, 0.5, 1.0), bandwidth
         20 MHz per 50 devices, and the paper's single cell (N=50) in
         float64; the SP1 kernel runs 3 times per batched BCD iteration;
       - the paper-literal SP2 (`core.sp2.solve_sp2_v2_thm2`, beside
         `solve_sp2_direct`) on one 2^17-device region in float32: 4
         `waterfill_gprime` launches per call and no host read;
       - the deadline-constrained fleet (C=64 x N=2048, float32), each
         cell's deadline 1.2 x its free-deadline total time;
       - a padded pool: 64 cells of 1025..2048 devices (seed 31), each
         padded to bucket_size = 2048 with masked lanes (`pad_system`) and
         solved as one stack: feasible, pad lanes at B = 0 and zero energy
         exactly, 3 SP1 launches per batched iteration; 4 of its cells
         re-solved unpadded in float64 against their padded solves;
       - the round-dynamics engine (`Problem.rounds`) on the C=64 x N=2048
         fleet: 8 rounds of Markov fading, stale participation, dropout
         0.05, 8 warm-started BCD iterations a round; every round's
         allocation feasible, 3 SP1 launches per batched iteration of
         every round;
       - implicit gradients (`repro_torch.diff.solve_and_grad`, 30 Neumann
         steps) on the same fleet: values against `solve`'s, every
         gradient finite, and on a 4-cell padded pool every pad lane's
         gradient exactly 0;
       - the region serving stack (`repro_torch.region`), float32,
         SolverSpec(max_iters=8, tol=1e-4): (a) examples/region_serve.py's
         256-request Poisson trace over 48 cells of 9-500 devices at 32
         cells a batch through `RegionPipeline` (<= 4 batch shapes, the
         metric plane's counts, the default SLOs' verdicts, a /metrics
         scrape on 127.0.0.1); (b) the padded pool's 64 cells as cold
         requests (recorded: plan / dispatch / materialize / solve spans,
         one request point each), a warm wave with 1% drift (fewer BCD
         iterations), the cold wave at depth 1 (bit-identical), one batch
         solved directly on its plan (bit-identical); `Problem.mesh` over
         `region_mesh()` on the C=64 x N=2048 fleet, shard-local and
         lockstep, bit-identical to the fleet solve; (c) `replay_mobility`
         of a 4-step random-waypoint trace of 16,384 devices over 16
         cells; every response finite and feasible, 3 sp1_lambda_sum
         launches per batched BCD iteration of every batch;
       - LM serving through `repro_torch.launch.serve.main` for
         internlm2-20b (dense GQA) and rwkv6-1.6b (RWKV6) at full width and
         depth, and jamba-1.5-large-398b (hybrid Mamba + MoE) at full width
         cut to its first 5 layers (mamba, mamba_moe, mamba, mamba_moe,
         attn), bf16, batch 4, 2048-token prompts, 32 greedy tokens: one
         flash_attention / rwkv6_scan / mamba_scan launch per attention /
         RWKV / Mamba layer in the prefill, none in decode; two runs give
         the same tokens, and a prefill over the prompt plus the first
         token matches the first decode step (the cache hand-over); every
         served flash_attention launch on the wgmma body, both rwkv6
         passes once per rwkv6_scan call;
     and checks that every output is finite and feasible;
  4. solves on the card and on the CPU (where the plain versions run) in
     float64 and compares them: the paper cell and 4 fleet cells (the
     default engines), an N=4096 slice of the region (Theorem 2 and
     direct), the Fig. 8 cell under three deadlines, the paper cell with
     SP1 "bisect", with SP2 "jong" (cut to 3 BCD x 5 Algorithm-1
     iterations) and with the log accuracy model, and 4 fleet cells under
     per-cell deadlines; and the reduced LMs in float32 (prefill and four
     decode steps): internlm2-20b, rwkv6-1.6b, jamba-1.5-large-398b and
     mixtral-8x7b; and in float64 the rounds engine on 4 cells x 64
     devices from one set of draws (locating the SP2 search with the
     largest eval gap and replaying it on the CPU with the card's inputs
     and with the card's exp / log1p), solve_and_grad on those 4 cells
     (Neumann) and on the paper cell (the dense adjoint), and the region
     serving trace (a) cut to 12 cells and 24 requests;
  5. times the warm fleet and deadline-fleet solves (median of 3) and each
     kernel per launch, by CUDA events over back-to-back wrapper calls
     (`ms`, the host included) and by torch.profiler's device time of its
     own kernels (`device_ms`), beside its bound, its plain version and,
     for attention, scaled_dot_product_attention (timed only), at both
     served attention shapes; rwkv6_scan also per pass; sp1_lambda_sum
     also in float64 and with the SASS instructions of its candidate loop
     (cuobjdump), one (m, n) pair a trip;
     waterfill_gprime with the Halley steps its early exit takes on the
     region (a plain replay of the exit rule);
  6. traces one fleet solve, one deadline-fleet solve, one warm
     Theorem-2 call on the region, one served batch of the region serving
     stack (its `solve` span's range holds all its sp1_lambda_sum kernels)
     and one LM prefill and decode step per configuration with
     torch.profiler: the card's
     busy time and idle share, the kernels that take the most time, and
     the port's own kernels.

Each phase's seconds are printed as it ends.

Each phase prints a JSON record. The line before the last lists the
kernels; the last line is {"ok": true, "device": {...}}. Any failure exits
non-zero without that line, as does a machine without CUDA or a directory
without the rest of the checkout. Weights and systems come from fixed
seeds; nothing is downloaded.
"""
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Main-path shapes: the fleet acceptance shape of the JAX package
# (benchmarks/run.py fleet_scale).
FLEET_C, FLEET_N, FLEET_ITERS, FLEET_SEED = 64, 2048, 8, 31
PAPER_N, PAPER_SEED = 50, 0
WEIGHTS = (0.5, 0.5, 1.0)
# The Theorem-2 region: examples/allocate_fleet.py section 3 (2^17 devices,
# 20 MHz per 50, f = 1 GHz, s = 320, T = 1.2 max t_cmp), compared with the
# CPU on its first REGION_SLICE devices.
REGION_N, REGION_SEED, REGION_SLICE = 1 << 17, 17, 4096
N_MU = 128   # candidates per Theorem-2 sweep (core/sp2.py::_thm2_dual_mu)
# The deadline variant: Fig. 8 of benchmarks/run.py (N = 12, p_max = 10 dBm,
# energy-heavy weights, max_iters = 6), and the full-width deadline fleet
# with each cell's deadline DEADLINE_SLACK x its free-deadline total time.
FIG8_N, FIG8_SEED, FIG8_PMAX_DBM = 12, 7, 10.0
FIG8_WEIGHTS, FIG8_DEADLINES, FIG8_ITERS = (0.99, 0.01, 1.0), (80.0, 120.0,
                                                             200.0), 6
DEADLINE_SLACK = 1.2
# The padded pool: FLEET_C cells of N_c devices, N_c uniform in
# PAD_N_LO..FLEET_N from PAD_SEED (the systems drawn from a generator of
# the same seed), each padded to bucket_size(N_c) = FLEET_N with masked
# lanes and solved as one (C, N) stack; PAD_F64_CELLS of them re-solved
# unpadded in float64 against their padded float64 solves.
PAD_N_LO, PAD_SEED, PAD_F64_CELLS = 1025, 31, 4
PAD_PREFIX_TOL = 1e-9
# The rounds fleet: the main path's fleet through R rounds of the
# round-dynamics engine, its draws from a torch.Generator of ROUNDS_SEED.
ROUNDS = dict(rounds=8, channel_mode="markov", drift_rho=0.9,
              participation="stale", dropout_prob=0.05, bcd_iters=8)
ROUNDS_SEED = 5
# Card vs CPU of the rounds engine and of solve_and_grad, float64: 4 cells
# of CPU_N devices.
CPU_N, CPU_ROUNDS = 64, dict(rounds=4, channel_mode="markov",
                             participation="stale", dropout_prob=0.05,
                             deadline_slack=0.98)
# solve_and_grad's values are one differentiable BCD step (its SP1 the
# nested bisection) past the forward solve's last iterate, which moves the
# objective by about the BCD tolerance plus the sweep's secant precision:
# 1.4e-5 .. 2.3e-5 relative on a 4 x 64 fleet on the CPU, <= 1.06e-5 on
# the C=64 x N=2048 fleet on the card
GRAD_VALUE_TOL = 1e-4
# Gradients card vs CPU, float64. They are not reproducible to 1e-8: on the
# CPU alone, gains moved by one ulp move the 4-cell Neumann gradients by up
# to 1.1e-6 (the run measures it again: `ulp_spread`), and the dense
# adjoint's I - Phi_x^T is numerically singular on the paper cell
# (condition ~1e20, measured in the run), so its solution is set by the
# LU's rounding: cuSOLVER's and LAPACK's differ. Values are held to 1e-8.
GRAD_CPU_TOL, DENSE_CPU_TOL = 1e-5, 1e-3
# the SP2 dual search's eval count rides data-dependent exits (ROADMAP
# Queue 3): per BCD iteration, card vs CPU. The card's exp and log1p differ
# from the CPU's in the last bit on a share of inputs (`card_vs_cpu`'s
# sp2_gap record replays the SP2 search that carries the largest gap on
# the CPU with the card's exp), and at a rate floor the last bit picks a
# branch of the dual search, which moves its exit by a few evaluations.
EV_SLACK_PER_ITER = 8
# The region serving stack (`repro_torch.region`), float32, served with
# examples/region_serve.py's tolerance. Trace (a) is that example's: 48
# cells with pools drawn from SERVE_POOLS, per-cell weights, 256 requests
# in Poisson ticks of SERVE_RATE distinct cells, 1% gain drift per
# re-request, buckets from 64. Cut: 32 cells a batch (the example's 8)
# under the default close-on-full policy, drained at the end, where the
# example flushes every tick — a batch costs ~1-2 s on the card whatever
# its width (launches and host reads, PERF.md section 5), and a flush per
# tick would solve ~110 batches of ~2 cells. The trace is replayed as fast
# as the pipeline takes it (no pacing). Card vs CPU runs its first
# SERVE_CPU_CELLS cells and SERVE_CPU_REQUESTS requests (the example's
# smoke size) in float64.
SERVE_CELLS, SERVE_REQUESTS, SERVE_RATE = 48, 256, 8.0
SERVE_DRIFT, SERVE_SEED = 0.01, 7
SERVE_POOLS = (9, 14, 23, 40, 65, 90, 150, 260, 410, 500)
SERVE_CPB, SERVE_MIN_BUCKET, SERVE_DEPTH = 32, 64, 2
SERVE_SPEC = dict(max_iters=8, tol=1e-4)
SERVE_CPU_CELLS, SERVE_CPU_REQUESTS = 12, 24
# Trace (c): replay_mobility of a random-waypoint trace (walking MAR users,
# MobilityConfig's defaults: 1 s steps, 0.5-2 m/s, 8 dB shadowing drifting
# at 0.9 a step) of MOB_DEVICES devices over MOB_CELLS cells of bs_grid
# (~1024 a cell), all cells of a bucket in one batch, buckets from 1024 so
# the menu is 1024 / 2048. At this size every cell hands some device over
# every step, so replay_mobility purges every cell and each re-request is
# cold.
MOB_CFG = dict(model="rwp", steps=4)
MOB_SEED, MOB_CELLS, MOB_DEVICES, MOB_MIN_BUCKET = 9, 16, 16384, 1024
# Algorithm 1 runs ~100k small launches per SP2_v2 solve; the paper cell's
# "jong" comparison is cut to 3 BCD x 5 Algorithm-1 iterations (the
# reference's defaults are 20 x 30) to stay inside the run's time limit.
JONG_SPEC = dict(max_iters=3, sp2_method="jong", sp2_iters=5)

# The LM serving path: internlm2-20b and rwkv6-1.6b at full width and
# depth, jamba-1.5-large-398b at full width cut to its first 5 of 72 layers
# (every layer kind of the model; 23.5 B parameters, 47 GB in bf16, where
# one 8-layer period would not fit the card), bf16, batch 4, 2048-token
# random prompts, 32 greedy tokens, weights from a seed.
LM_DENSE, LM_RWKV, LM_HYBRID = "internlm2-20b", "rwkv6-1.6b", \
    "jamba-1.5-large-398b"
LM_HYBRID_LAYERS = 5
LM_MOE = "mixtral-8x7b"     # card vs CPU at the reduced size only
LM_BATCH, LM_PROMPT, LM_GEN, LM_SEED = 4, 2048, 32, 0
# Last-position logits of a prefill over prompt + first token against the
# first decode step's, relative to the largest logit: bf16 rounds the two
# paths differently (the prefill's flash kernel and decode's plain attention
# round scores and probs at different points; the rwkv token shift is cached
# in bf16).
LM_HANDOVER_TOL = 5e-2
# card vs CPU on the reduced configs in float32 (TF32 off): logits to 1e-4
LM_CARD_CPU_TOL = 1e-4
# flash kernel vs plain, per element: |kernel - plain| <= tol |plain|
# + 4 u r + atol. tol is tests/test_kernels.py's (bf16: over two bf16 ulps of
# |o|, so the output's own rounding fits). The bf16 kernel rounds P to bf16
# (unit roundoff u = 2^-8) before P V, the plain version keeps it in float32:
# that makes an error of about u r, r = sqrt(sum_t p_t^2 v_t^2), large in the
# first rows (a few keys) and small past them. float32 keeps P (u = 0).
# atol is a floor for outputs near 0.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_ATOL = {"float32": 2e-6, "bfloat16": 1e-4}
FLASH_P_ROUNDOFF = {"float32": 0.0, "bfloat16": 2.0 ** -8}
RWKV_TOL = 1e-4
# mamba_scan vs plain, y and the final state: |kernel - plain| <= tol (1 +
# |plain|). Both run the same float32 recurrence; the kernel fuses a h + u
# and sums over n in another order, ~1e-7 relative a step.
MAMBA_TOL = 1e-4

# Published H100 SXM peaks (NVIDIA data sheet, dense, no sparsity): HBM3
# bandwidth, the FP32 / FP64 rates outside the tensor cores, and the bf16
# tensor-core rate.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
# exponentials on the special-function units: 16 per SM a clock (Hopper),
# 132 SMs at the 1.98 GHz boost clock
SFU_EXP_S = 16 * 132 * 1.98e9

# Floating-point operations of sp1_lambda_sum, counting each add, multiply,
# divide, compare-and-select, sqrt, cbrt and pow of lambda_of_T_linear as
# one, each where it first can be formed: per (m, n) pair, per device (c, n)
# or per cell c. The clip-and-validate of a candidate is 24: the NaN select
# 1, the clip to [0, lam_hi] 2, lam / k3_safe 1, cbrt 1, the f clip 2,
# max(f, 1e-9) 1, psi 7 (2 alpha, f f, their product, 2 lam, times q, over
# fs, the sum), max(psi, tiny) 1, rhok / psi 1, the s clip 2, q s^2 / fs 3,
# the difference from t_c and its magnitude 2.
# Per pair: t_c 2; per f-clipped candidate 8 (t_c F / q_safe and its sqrt
# 3, rhok / max(s, tiny) 2, the difference, times F, over 2 q_safe 3); per
# s-clipped one 4 (q S^2 / t_c 1, k3 f^3 3); the interior one 7 (q t_c, its
# clamp and ^-0.2, the product with the cell's factor, k3 f^3 3); the
# lambda = 0 candidate's |mk0 - t_c| 2; the other five validates less
# 2 alpha, 23 each; the pick 18 (the best of 6 5, the tie bar 2, 6
# near-tie selects, the least of 6 5); the unattainable test 2; the sum 1.
SP1_OPS_PER_PAIR = 2 + 2 * 8 + 2 * 4 + 7 + 2 + 5 * 23 + 18 + 2 + 1
# Where the deadline is unattainable (makespan floor > t_c) the result is
# lam_hi whatever the candidates give: such a pair needs t_c, the test, the
# select and the sum.
SP1_OPS_PER_SATURATED_PAIR = 2 + 2 + 1
# Per device: q_safe 1, alpha 1, 2 alpha 1, 2 alpha F^2 2, 2 q_safe 1,
# q S^2 2, the makespan floor 1, and the lambda = 0 candidate's makespan 11
# (2 alpha f0^2 1, 2 lam0 q 1, over fs0 1, the sum 1, max(psi, tiny) 1,
# rhok / psi 1, the s clip 2, q s^2 / fs0 3).
SP1_OPS_PER_DEVICE = 1 + 1 + 1 + 2 + 1 + 2 + 1 + 11
# Per cell: k3_safe 1, 0.5 k3 1, F^2 2, S^2 2, (rhok / max(3 k3, tiny))^0.4
# 4, max(f_max, 1e-9) 1, the lambda = 0 candidate's clip and f0 8 (the NaN
# select, the clip 2, lam / k3_safe, cbrt, the f clip 2, max(f, 1e-9)),
# f0^2 1 and 2 lam0 1.
SP1_OPS_PER_CELL = 1 + 1 + 2 + 2 + 4 + 1 + 8 + 1 + 1

# Floating-point operations of one (m, n) pair of waterfill_gprime, counted
# the same way (exp, log, sqrt and division as one each): the ratio
# q = mu/j (1); the seed (37: clamp 1, z 2, p 2, the 4-term series 13, the
# two logs with their clamps 4, w_big 4, w_small 5, the branch selects 4,
# the clamp at -1 + eps 2); 24 Halley steps of 17 (exp 1, f 2, w + 1 1,
# the denominator 6, its tiny guard 3, the step 2, the clamp 2); the
# q < 1e-3 cut-over (2); the summand and the sum (5).
WATERFILL_OPS_PER_PAIR = 1 + 37 + 24 * 17 + 2 + 5
# The same count for the kernel's early-exit form at a given number of
# Halley steps: the 45 operations around the loop, and per step its 17 and
# the two bitwise exit tests (2). Recorded beside the bound as
# `bound_fixed_point_ms`, at the steps a plain replay of the exit rule takes
# on this run's input; the bound itself stays the 24-step function's.
WATERFILL_OPS_OUTSIDE_HALLEY = 1 + 37 + 2 + 5
WATERFILL_OPS_PER_EXIT_STEP = 17 + 2

TOL_F64 = 1e-10   # relative (a zero sum must come out exactly zero)
TOL_F32 = 1e-4    # relative to max(|sum|, 1e-6 * lam_hi * N)
# waterfill_gprime, relative to max(|g + B_total|, Sigma rmin ln2): every
# term is positive, so g + B_total is the sum's own scale, and Sigma rmin
# ln2 (its value at W + 1 = 1) floors it where W + 1 is large. float32 sums
# up to 2^17 terms in two different orders, and near the branch point a
# term's W + 1 ~ sqrt(2q) comes out of -1 + p(...) with ~6e-8 / sqrt(2q) of
# relative rounding, so a last-bit difference between the two versions'
# exp, log or sums is amplified there.
WF_TOL_F64, WF_TOL_F32 = 1e-10, 1e-4


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def record(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def ptxas_entries(log):
    """ptxas's report per kernel entry: "<kernel><template args>:
    <registers, shared memory>; <stack, spills>", the kernel's name read
    out of the mangled entry (a length, then that many characters)."""
    out, entry, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            entry = name[-72:]
            for m in re.finditer(r"(\d+)([a-z])", name):
                at, digits = m.start(2), m.group(1)
                idents = [name[at:at + int(digits[d:])]
                          for d in range(len(digits))]
                ident = next((i for i in idents if i.endswith("_kernel")),
                             None)
                if ident:
                    args = re.match(r"(I.*?E)Ev", name[at + len(ident):])
                    entry = ident + (args.group(1) if args else "")
                    break
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and entry:
            out.append(f"{entry}: {ln.split(':', 1)[1].strip()}; {spill}")
            entry, spill = None, ""
    return out


def main():
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        raise SmokeError(f"no src/repro_torch beside {Path(__file__).name}: "
                         "run it from the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    sources = build.sources()
    t0 = time.perf_counter()
    built = build.build(sources)
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_entries(build.log_path(name).read_text())
             for name in sources}
    record("env", card=smi, device=torch.cuda.get_device_name(0),
           count=torch.cuda.device_count(), torch=torch.__version__,
           cuda=torch.version.cuda, python=sys.version.split()[0],
           build_s=build_s, built=built, ptxas=ptxas)

    seconds = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(torch, *args)
        seconds[name] = time.perf_counter() - t
        record("phase_seconds", name=name, seconds=seconds[name])
        return out

    kernels = [phase(name, check_fn)
               for _, name, check_fn, _ in KERNELS.values()]
    fleet_run = phase("main_path", phase_main_path)
    kernels[0]["launches"] = fleet_run["launches"]["sp1_lambda_sum"]
    region_run = phase("region_sp2", phase_region_sp2)
    kernels[1]["launches"] = region_run["launches"]["waterfill_gprime"]
    serve_runs = phase("lm_serve", phase_lm_serve)
    for k in kernels[2:]:
        k["launches"] = sum(r["launches"][k["name"]]
                            for r in serve_runs.values())
    phase("deadline_fleet", phase_deadline_fleet)
    sp1_paths = {"main_path": fleet_run["launches"]["sp1_lambda_sum"]}
    for name, fn in (("padded_fleet", phase_padded_fleet),
                     ("rounds_fleet", phase_rounds_fleet),
                     ("grad", phase_grad)):
        sp1_paths[name] = phase(name, fn)["launches"]["sp1_lambda_sum"]
    phase("card_vs_cpu", phase_card_vs_cpu)
    phase("paper_paths", phase_paper_paths)
    phase("lm_card_vs_cpu", phase_lm_card_vs_cpu)
    phase("kernel_times", phase_times, kernels)
    # after kernel_times: run before it, the serving traces' millions of
    # small launches left the mamba timing's profile with no launch caught
    sp1_paths["region_serve"] = phase(
        "region_serve", phase_region_serve)["launches"]["sp1_lambda_sum"]
    kernels[0]["launches"] = sum(sp1_paths.values())
    kernels[0]["launches_by_path"] = sp1_paths
    phase("profile", phase_profile)
    record("phase_seconds", total=sum(seconds.values()), **seconds)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def fleet_system(torch, dtype, n_cells=None, n_devices=None):
    from repro_torch import make_fleet

    n_cells = FLEET_C if n_cells is None else n_cells
    n_devices = FLEET_N if n_devices is None else n_devices
    return make_fleet(FLEET_SEED, n_cells, n_devices, device="cuda",
                      dtype=dtype, bandwidth_total=20e6 * n_devices / 50)


def sweep_inputs(torch, sysp, weights=WEIGHTS):
    """The SP1 sweep's first-round kernel inputs for `sysp` at its initial
    allocation, ((T_grid (C, 16), q / tt (C, N), consts (C, 8)), target
    (C, 1)), and the number of devices per cell whose makespan floor lies
    within 16 ulps of the grid's first point T_lo (C,)."""
    from repro_torch.api.problem import weights_leaf
    from repro_torch.core.accuracy import default_accuracy
    from repro_torch.core.bcd import initial_allocation
    from repro_torch.core.energy import rate
    from repro_torch.core.sp1 import (_SWEEP_POINTS, _coeffs, _geomspace,
                                      _sp1_bounds, _sweep_consts)
    from repro_torch.core.types import Weights

    b = sysp.batched()
    alloc = initial_allocation(b)
    tt = b.bits / torch.clamp_min(rate(b, alloc.bandwidth, alloc.power),
                                  1e-12)
    warr = weights_leaf(Weights(*weights), b.dtype, b.device,
                        cells=b.gain.shape[0])
    w = Weights(warr[:, 0:1], torch.clamp_min(warr[:, 1:2], 1e-9),
                warr[:, 2:3])
    _, q = _coeffs(b, w)
    lam_hi, target, T_lo, T_hi = _sp1_bounds(b, w, q, tt)
    consts = _sweep_consts(b, w, default_accuracy(), lam_hi)
    grid = _geomspace(T_lo, T_hi, _SWEEP_POINTS).contiguous()
    floor = q * b.s_lo ** 2 / b.f_max + tt
    n_edge = (floor >= grid[:, :1] * (1 - 16 * torch.finfo(b.dtype).eps)
              ).sum(-1)
    return (grid, q.contiguous(), tt.contiguous(), consts), target, n_edge


def bracket_index(torch, S, target):
    """The sweep's bracket pick from the sums S (C, M), as in
    `core/sp1.py::_solve_sp1_sweep_impl`."""
    n = S.shape[-1]
    index = torch.arange(n, device=S.device)
    first = torch.where(S < target, index, n).amin(-1, keepdim=True)
    return torch.where(first == n, n - 1, torch.clamp_min(first, 1))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def sp1_case(torch, args, target, n_edge, where):
    """One sp1_lambda_sum case against its plain version: finite, two
    launches bitwise equal, within the dtype's tolerance (beyond the tied
    devices at T_lo), the same bracket pick. Returns (case record, kernel
    sums, abs err off the edge column)."""
    from repro_torch.kernels import sp1_sweep

    dtype = args[1].dtype
    tol = TOL_F32 if dtype == torch.float32 else TOL_F64
    c, n = args[1].shape
    out = sp1_sweep.sp1_lambda_sum(*args)
    again = sp1_sweep.sp1_lambda_sum(*args)
    plain = sp1_sweep.sp1_lambda_sum_ref(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()),
          f"sp1_lambda_sum: non-finite sums ({where})")
    check(torch.equal(out, again),
          f"sp1_lambda_sum: two launches differ ({where})")
    lam_hi = args[3][:, 6:7]
    floor = 1e-6 * lam_hi * n if dtype == torch.float32 \
        else torch.full_like(plain, torch.finfo(dtype).tiny)
    scale = torch.maximum(plain.abs(), floor)
    err = (out - plain).abs()
    # The first grid point is T_lo = max makespan floor * (1 + 1e-12), and
    # 1 + 1e-12 rounds to 1 in float32: a device whose floor lies within
    # ulps of T_lo sits on its attainability edge, where every lambda from
    # its corner value up to lam_hi ties in makespan and rounding picks
    # one. There the two versions may differ by up to lam_hi per such
    # device (n_edge, counted from the inputs: 1 per cell in float32, 0 in
    # float64); every other grid point is held to the tolerance, and the
    # bracket pick must agree.
    edge = n_edge.to(dtype)[:, None] * lam_hi
    cols = slice(1, None) if bool((n_edge > 0).any()) else slice(None)
    rel = float((err / scale)[:, cols].max())
    abs_err = float(err[:, cols].max())
    edge_err = float((err[:, :1] - edge).max())
    same_bracket = torch.equal(bracket_index(torch, out, target),
                               bracket_index(torch, plain, target))
    case = dict(dtype=str(dtype).removeprefix("torch."), C=c,
                M=args[0].shape[1], N=n, max_rel_err=rel, max_abs_err=abs_err,
                tol=tol, n_edge=int(n_edge.max()),
                edge_abs_err=float(err[:, 0].max()),
                edge_excess_over_tie=edge_err, same_bracket=same_bracket)
    check(rel <= tol, f"sp1_lambda_sum: kernel vs plain rel err "
                      f"{rel:.3g} > {tol:g} ({where})")
    check(bool((err[:, :1] <= edge + tol * scale[:, :1]).all()),
          f"sp1_lambda_sum: at T_lo kernel and plain differ by "
          f"{edge_err:.3g} beyond {int(n_edge.max())} tied device(s) "
          f"({where})")
    check(same_bracket, f"sp1_lambda_sum: kernel and plain sums pick "
                        f"different brackets ({where})")
    return case, out, abs_err


def sp1_zero_lane_case(torch, dtype):
    """The padded pool's sweep inputs (cell c: N_c real devices, then
    FLEET_N - N_c zero-data lanes, q = 0 and tt = 0, inside N), with the
    last cell made all zero-data on its own finite grid: kernel against
    plain as every case, each zero lane's plain lambda exactly 0, each
    cell's sums against the kernel over its non-zero prefix alone, and the
    all-zero cell's sums exactly 0.0."""
    from repro_torch.kernels import sp1_sweep

    pool, _, sizes = padded_pool(torch, dtype)
    (grid, q, tt, consts), target, n_edge = sweep_inputs(torch, pool)
    q[-1], tt[-1] = 0.0, 0.0
    sizes = sizes[:-1] + [0]
    args = (grid, q, tt, consts)
    where = f"zero-data lanes, {dtype}"
    case, out, _ = sp1_case(torch, args, target, n_edge, where)
    k = [consts[:, i, None, None] for i in range(7)]
    lam = sp1_sweep.lambda_of_T_linear(grid[:, :, None], q[:, None, :],
                                       tt[:, None, :], *k)
    lanes = torch.arange(FLEET_N, device=q.device)
    pad = lanes[None, :] >= torch.tensor(sizes, device=q.device)[:, None]
    plain_zero = bool((lam.masked_select(pad[:, None, :]) == 0).all())
    prefix_rel, bitwise = 0.0, 0
    tol = TOL_F32 if dtype == torch.float32 else TOL_F64
    for c, n in enumerate(sizes[:-1]):
        alone = sp1_sweep.sp1_lambda_sum(
            grid[c:c + 1].contiguous(), q[c:c + 1, :n].contiguous(),
            tt[c:c + 1, :n].contiguous(), consts[c:c + 1].contiguous())
        scale = alone.abs().clamp_min(
            1e-6 * float(consts[c, 6]) * n if dtype == torch.float32
            else torch.finfo(dtype).tiny)
        prefix_rel = max(prefix_rel,
                         float(((out[c:c + 1] - alone).abs() / scale).max()))
        bitwise += int(torch.equal(out[c:c + 1], alone))
    zero_cell = out[-1].tolist()
    case.update(zero_lanes=int(pad.sum()),
                tails=[min(FLEET_N - n for n in sizes[:-1]),
                       max(FLEET_N - n for n in sizes[:-1])],
                plain_zero_lanes_exact=plain_zero,
                prefix_max_rel_err=prefix_rel,
                prefix_bitwise_cells=bitwise, zero_cell_sums=zero_cell)
    check(plain_zero, f"sp1_lambda_sum: a zero-data lane's plain lambda is "
                      f"not 0 ({where})")
    check(prefix_rel <= tol, f"sp1_lambda_sum: a cell's sums differ from "
                             f"its non-zero prefix's by {prefix_rel:.3g} "
                             f"({where})")
    check(all(x == 0.0 for x in zero_cell),
          f"sp1_lambda_sum: the all-zero cell sums to {zero_cell} ({where})")
    return case


def phase_sp1_kernel(torch):
    """sp1_lambda_sum against its plain version on the card."""
    from repro_torch import make_system

    inputs = [(dtype, fleet_system(torch, dtype, FLEET_C if n == FLEET_N
                                   else 4, n), weights, n == FLEET_N)
              for dtype in (torch.float32, torch.float64)
              for n, weights in ((FLEET_N, WEIGHTS), (5, WEIGHTS),
                                 (1500, WEIGHTS), (1500, (0.0, 1.0, 1.0)))]
    # the single-cell path's shape: the paper cell (C=1, N=50, float64)
    inputs.append((torch.float64, make_system(
        PAPER_SEED, n_devices=PAPER_N, device="cuda", dtype=torch.float64),
        WEIGHTS, True))
    main_abs_err = 0.0
    cases = []
    for dtype, sysp, weights, on_main_path in inputs:
        args, target, n_edge = sweep_inputs(torch, sysp, weights)
        where = f"C={args[1].shape[0]}, N={args[1].shape[1]}, " \
                f"w1={weights[0]}, {dtype}"
        case, _, abs_err = sp1_case(torch, args, target, n_edge, where)
        cases.append(dict(case, w1=weights[0]))
        if on_main_path:
            main_abs_err = max(main_abs_err, abs_err)
    for dtype in (torch.float32, torch.float64):
        cases.append(sp1_zero_lane_case(torch, dtype))
    record("kernel_vs_plain", kernel="sp1_lambda_sum", cases=cases)
    return dict(name="sp1_lambda_sum", route="cuda",
                source="src/repro_torch/kernels/csrc/sp1_sweep.cu",
                replaces="src/repro/kernels/sp1_sweep.py:121",
                launches=None, max_abs_err=main_abs_err)


def thm2_instance(torch, sysp):
    """SP2 inputs of a system at the equal split at p_max, as the tests
    build them: rmin from f = 1 GHz, s = 320 and a deadline of 1.2 x each
    cell's slowest compute time, and the duals (nu, beta) of weights
    (0.5, 0.5, 1.0). Tensors are shaped like the system's."""
    from repro_torch.core.energy import t_cmp
    from repro_torch.core.sp2 import G, r_min
    from repro_torch.core.types import Weights

    shape, dev, dt = sysp.gain.shape, sysp.device, sysp.dtype
    f = torch.full(shape, 1e9, dtype=dt, device=dev)
    s = torch.full(shape, 320.0, dtype=dt, device=dev)
    T = t_cmp(sysp, f, s).amax(-1, keepdim=True) * 1.2
    rmin = r_min(sysp, f, s, T)
    B0 = torch.broadcast_to(sysp.bandwidth_total / shape[-1], shape)
    p0 = torch.broadcast_to(sysp.p_max, shape)
    rate0 = G(sysp, p0, B0)
    w1 = Weights(*WEIGHTS).normalized().w1
    return rmin, w1 * sysp.global_rounds / rate0, p0 * sysp.bits / rate0


def region_system(torch, dtype, keep=None, device="cuda"):
    """The section-3 region of examples/allocate_fleet.py (2^17 devices,
    20 MHz per 50); with `keep`, the first `keep` devices of the same draw
    with the bandwidth scaled to 20 MHz per 50 of them."""
    from repro_torch import make_system
    from repro_torch.core.types import SYS_ARRAYS

    sysp = make_system(REGION_SEED, n_devices=REGION_N, device="cpu",
                       dtype=torch.float64,
                       bandwidth_total=20e6 * REGION_N / 50)
    if keep is not None:
        sysp = sysp.replace(
            **{k: getattr(sysp, k)[:keep] for k in SYS_ARRAYS},
            bandwidth_total=torch.tensor(20e6 * keep / 50,
                                         dtype=torch.float64))
    return sysp.to(device=device, dtype=dtype)


def thm2_sweep_inputs(torch, sysp, nu, rmin, grid=None):
    """The Theorem-2 dual search's first `waterfill_gprime` launch for
    (sysp, nu, rmin), as `core/sp2.py::_thm2_dual_mu` makes it:
    (mu (C, 128), j (C, N), rmin (C, N), B_total (C,)). `grid(j)` replaces
    the multiplier grid."""
    from repro_torch.core.sp1 import _cells_view, _geomspace
    from repro_torch.core.sp2 import _clamp_rmin, _thm2_bracket, _thm2_j

    b, (nu, rmin) = _cells_view(sysp, nu, rmin)
    rmin = _clamp_rmin(b, rmin)
    j = _thm2_j(b, nu)
    mu = _geomspace(*_thm2_bracket(b, j, rmin), N_MU) if grid is None \
        else grid(j)
    return (mu.contiguous(), j.contiguous(), rmin.contiguous(),
            b.bandwidth_total.reshape(-1).contiguous())


def waterfill_cases(torch, dtype):
    """(name, on the main path, kernel inputs) for every case the kernel is
    held to in `dtype`."""
    from repro_torch import make_system
    from repro_torch.core.sp1 import _geomspace

    cases = []
    region = region_system(torch, dtype)
    rmin, nu, _ = thm2_instance(torch, region)
    cases.append(("region", True, thm2_sweep_inputs(torch, region, nu, rmin)))
    for c, n in ((FLEET_C, FLEET_N), (4, 7), (4, 1000), (4, 1500)):
        fleet = fleet_system(torch, dtype, c, n)
        rmin, nu, _ = thm2_instance(torch, fleet)
        cases.append((f"fleet.C{c}.N{n}", False,
                      thm2_sweep_inputs(torch, fleet, nu, rmin)))
    # mu << j: q = mu/j from 1e-6 up to past the series cut-over at 1e-3
    fleet = fleet_system(torch, dtype, 2, 1000)
    rmin, nu, _ = thm2_instance(torch, fleet)
    cases.append(("branch_point", False, thm2_sweep_inputs(
        torch, fleet, nu, rmin,
        grid=lambda j: _geomspace(1e-6 * j.amin(-1, keepdim=True),
                                  1e-2 * j.amax(-1, keepdim=True), N_MU))))
    # tests/test_fleet.py's tight deadline: ~100 nats, root near 1e33 in
    # float64 (the bracket runs up to the dtype's cap)
    cell = make_system(PAPER_SEED, n_devices=PAPER_N, device="cuda",
                       dtype=dtype)
    _, nu, _ = thm2_instance(torch, cell)
    rmin = torch.full_like(nu, 100.0 * float(cell.bandwidth_total)
                           / (PAPER_N * math.log(2.0)))
    cases.append(("tight_deadline", False,
                  thm2_sweep_inputs(torch, cell, nu, rmin)))
    return cases


def phase_waterfill_kernel(torch):
    """waterfill_gprime against its plain version on the card."""
    from repro_torch.kernels import waterfill

    main_abs_err = 0.0
    rows = []
    for dtype in (torch.float32, torch.float64):
        tol = WF_TOL_F32 if dtype == torch.float32 else WF_TOL_F64
        for name, on_main_path, args in waterfill_cases(torch, dtype):
            mu, j, rmin, b_total = args
            out = waterfill.waterfill_gprime(*args)
            again = waterfill.waterfill_gprime(*args)
            plain = waterfill.waterfill_gprime_ref(*args)
            torch.cuda.synchronize()
            where = f"{name}, C={j.shape[0]}, N={j.shape[1]}, {dtype}"
            check(bool(torch.isfinite(out).all()),
                  f"waterfill_gprime: non-finite sums ({where})")
            check(torch.equal(out, again),
                  f"waterfill_gprime: two launches differ ({where})")
            scale = torch.maximum((plain + b_total[:, None]).abs(),
                                  rmin.sum(-1, keepdim=True) * math.log(2.0))
            err = (out - plain).abs()
            rel = float((err / scale).max())
            abs_err = float(err.max())
            same_sign = torch.equal(out < 0, plain < 0)
            same_bracket = torch.equal(bracket_index(torch, out, 0.0),
                                       bracket_index(torch, plain, 0.0))
            if on_main_path:
                main_abs_err = max(main_abs_err, abs_err)
            rows.append(dict(case=name, dtype=str(dtype).removeprefix(
                "torch."), C=j.shape[0], M=mu.shape[1], N=j.shape[1],
                mu_max=float(mu.max()), max_rel_err=rel, max_abs_err=abs_err,
                tol=tol, same_sign=same_sign, same_bracket=same_bracket))
            check(rel <= tol, f"waterfill_gprime: kernel vs plain rel err "
                              f"{rel:.3g} > {tol:g} ({where})")
            check(same_sign and same_bracket,
                  f"waterfill_gprime: kernel and plain sums differ in sign "
                  f"or bracket ({where})")
    record("kernel_vs_plain", kernel="waterfill_gprime", cases=rows)
    tight = [r for r in rows if r["case"] == "tight_deadline"
             and r["dtype"] == "float64"]
    check(tight[0]["mu_max"] > 1e30,
          "waterfill_gprime: the tight-deadline grid does not reach 1e30")
    return dict(name="waterfill_gprime", route="cuda",
                source="src/repro_torch/kernels/csrc/waterfill.cu",
                replaces="src/repro/kernels/waterfill.py:77",
                launches=None, max_abs_err=main_abs_err)


def feasible_cells(torch, sysp, alloc):
    """Per-cell feasibility of a (C, N) allocation, sums in float64."""
    b = sysp.batched()
    C = b.gain.shape[0]
    B, p, f, s = (x.reshape(C, -1).double()
                  for x in (alloc.bandwidth, alloc.power, alloc.freq,
                            alloc.resolution))
    menu = torch.as_tensor(b.resolutions, dtype=torch.float64,
                           device=B.device)
    checks = {
        "finite": all(bool(torch.isfinite(x).all()) for x in (B, p, f, s)),
        "bandwidth": bool((B >= 0).all() and (B.sum(-1, keepdim=True)
                          <= b.bandwidth_total.double() * (1 + 1e-6)).all()),
        "power": bool(((p >= b.p_min.double() * (1 - 1e-6))
                       & (p <= b.p_max.double() * (1 + 1e-6))).all()),
        "freq": bool(((f >= b.f_min.double() * (1 - 1e-6))
                      & (f <= b.f_max.double() * (1 + 1e-6))).all()),
        "resolution": bool(((s[..., None] - menu).abs().amin(-1)
                            < 1e-3).all()),
    }
    return checks


def counted(torch, fn):
    """fn() with every kernel's launch count and the host-read count set to
    0 just before and read just after. Returns (result, {kernel: launches},
    host reads, wall seconds)."""
    from repro_torch.core.loops import while_cells
    from repro_torch.kernels import (flash_attention, mamba_scan, rwkv6_scan,
                                     sp1_sweep, waterfill)

    kernels = {"sp1_lambda_sum": sp1_sweep.sp1_lambda_sum,
               "waterfill_gprime": waterfill.waterfill_gprime,
               "flash_attention": flash_attention.flash_attention,
               "rwkv6_scan": rwkv6_scan.rwkv6_scan,
               "mamba_scan": mamba_scan.mamba_scan}
    for k in kernels.values():
        k.launches = 0
    flash_attention.reset_launches()
    rwkv6_scan.reset_launches()
    while_cells.host_reads = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: k.launches for name, k in kernels.items()}
    return res, counts, while_cells.host_reads, wall


def counted_solve(torch, problem, spec):
    """`repro_torch.solve` under `counted`."""
    from repro_torch import solve

    return counted(torch, lambda: solve(problem, spec))


def phase_main_path(torch):
    from repro_torch import Problem, SolverSpec, Weights, make_system

    fleet = fleet_system(torch, torch.float32)
    spec = SolverSpec(max_iters=FLEET_ITERS)
    res, counts, reads, wall = counted_solve(
        torch, Problem(system=fleet, weights=Weights(*WEIGHTS)), spec)
    iters = res.iters.cpu()
    batched_iters = int(iters.max())
    feas = feasible_cells(torch, fleet, res.allocation)
    obj = res.objective.double()
    run = dict(topology="fleet", C=FLEET_C, N=FLEET_N, dtype="float32",
               max_iters=FLEET_ITERS, first_call_s=wall,
               converged=int(res.converged.sum()), cells=FLEET_C,
               iters=iters.tolist(), batched_iters=batched_iters,
               mean_objective=float(obj.mean()),
               objective_finite=bool(torch.isfinite(obj).all()),
               feasible=feas, launches=counts, host_reads=reads,
               sp2_evals=res.counters.sp2_evals.double().mean().item())
    record("main_path", **run)
    check(run["objective_finite"] and all(feas.values()),
          f"fleet: infeasible or non-finite result {feas}")
    check(counts["sp1_lambda_sum"] > 0, "fleet: sp1_lambda_sum never ran")
    check(counts["sp1_lambda_sum"] == 3 * batched_iters,
          f"fleet: {counts['sp1_lambda_sum']} launches for "
          f"{batched_iters} batched BCD iterations (want 3 each)")

    cell = make_system(PAPER_SEED, n_devices=PAPER_N, device="cuda",
                       dtype=torch.float64)
    res1, counts1, reads1, wall1 = counted_solve(
        torch, Problem(system=cell, weights=Weights(*WEIGHTS)), SolverSpec())
    feas1 = feasible_cells(torch, cell, res1.allocation)
    record("main_path", topology="single", N=PAPER_N, dtype="float64",
           first_call_s=wall1, iters=res1.iters, converged=res1.converged,
           objective=res1.objective, feasible=feas1, launches=counts1,
           host_reads=reads1, counters=res1.counters.as_dict())
    check(math.isfinite(res1.objective) and all(feas1.values()),
          f"single cell: infeasible or non-finite result {feas1}")
    check(counts1["sp1_lambda_sum"] == 3 * res1.iters,
          f"single cell: {counts1['sp1_lambda_sum']} launches for "
          f"{res1.iters} BCD iterations")
    return dict(launches=counts, host_reads=reads)


def sp2_feasible(torch, sysp, p, B):
    """Finite, inside the budget (sums in float64) and inside the power
    box, per cell."""
    b = sysp.batched()
    C = b.gain.shape[0]
    p, B = p.reshape(C, -1).double(), B.reshape(C, -1).double()
    return {
        "finite": bool(torch.isfinite(p).all() and torch.isfinite(B).all()),
        "bandwidth": bool((B >= 0).all() and (B.sum(-1, keepdim=True)
                          <= b.bandwidth_total.double() * (1 + 1e-6)).all()),
        "power": bool(((p >= b.p_min.double() * (1 - 1e-6))
                       & (p <= b.p_max.double() * (1 + 1e-6))).all()),
    }


def max_rel(torch, a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float(((a - b).abs() / b.abs().clamp_min(1e-300)).max())


def phase_region_sp2(torch):
    """The paper-literal SP2 of one 2^17-device region in float32 (the
    Theorem-2 path through `waterfill_gprime`, beside the default direct
    solve), then card vs CPU on an N=4096 slice of it in float64."""
    from repro_torch.core.sp2 import solve_sp2_direct, solve_sp2_v2_thm2
    from repro_torch.core.types import Weights

    w = Weights(*WEIGHTS)
    region = region_system(torch, torch.float32)
    rmin, nu, beta = thm2_instance(torch, region)
    (p_d, B_d), counts_d, reads_d, wall_d = counted(
        torch, lambda: solve_sp2_direct(region, rmin))
    (p_t, B_t), counts, reads, wall = counted(
        torch, lambda: solve_sp2_v2_thm2(region, w, nu, beta, rmin))
    warm = [counted(torch, lambda: solve_sp2_v2_thm2(region, w, nu, beta,
                                                     rmin)) for _ in range(3)]
    feas_d = sp2_feasible(torch, region, p_d, B_d)
    feas_t = sp2_feasible(torch, region, p_t, B_t)

    piece = region_system(torch, torch.float64, keep=REGION_SLICE)
    rmin_s, nu_s, beta_s = thm2_instance(torch, piece)
    cpu = piece.to("cpu")
    slice_diff = {}
    for name, fn in (("thm2", lambda sp, a, b, c: solve_sp2_v2_thm2(
            sp, w, a, b, c)), ("direct", lambda sp, a, b, c:
                               solve_sp2_direct(sp, c))):
        pg, Bg = fn(piece, nu_s, beta_s, rmin_s)
        pc, Bc = fn(cpu, nu_s.cpu(), beta_s.cpu(), rmin_s.cpu())
        slice_diff[name] = dict(B=max_rel(torch, Bg, Bc),
                                p=max_rel(torch, pg, pc))
    run = dict(N=REGION_N, dtype="float32", launches=counts,
               host_reads=reads, first_call_s=wall,
               warm_walls_s=[x[3] for x in warm],
               warm_median_s=statistics.median(x[3] for x in warm),
               warm_launches=[x[1]["waterfill_gprime"] for x in warm],
               warm_host_reads=[x[2] for x in warm],
               thm2_feasible=feas_t, thm2_sum_B=float(B_t.double().sum()),
               thm2_energy=transmit_energy(torch, region, p_t, B_t),
               direct_s=wall_d, direct_host_reads=reads_d,
               direct_launches=counts_d, direct_feasible=feas_d,
               direct_energy=transmit_energy(torch, region, p_d, B_d),
               B_total=float(region.bandwidth_total),
               slice_N=REGION_SLICE, slice_card_vs_cpu=slice_diff)
    record("region_sp2", **run)
    check(all(feas_t.values()) and all(feas_d.values()),
          f"region: infeasible or non-finite SP2 result {feas_t} {feas_d}")
    for c, r, where in [(counts, reads, "first call")] + [
            (x[1], x[2], "warm call") for x in warm]:
        check(c["waterfill_gprime"] == 4,
              f"region: {c['waterfill_gprime']} waterfill_gprime launches "
              f"per Theorem-2 call ({where}), want 4")
        check(r == 0, f"region: {r} host reads in a Theorem-2 call ({where})")
    for name, d in slice_diff.items():
        check(max(d.values()) <= 1e-8,
              f"region slice: card vs CPU {name} differs by {d}")
    return dict(launches=counts, host_reads=reads,
                warm_median_s=run["warm_median_s"])


def transmit_energy(torch, sysp, p, B):
    """Sigma_n p d / G(p, B) of one allocation, in float64."""
    from repro_torch.core.sp2 import G

    s64 = sysp.to(dtype=torch.float64)
    p, B = p.double(), B.double()
    return float((p * s64.bits / torch.clamp_min(G(s64, p, B), 1e-12)).sum())


def deadline_problem(torch, fleet, free):
    """The deadline-fleet problem: each cell's deadline DEADLINE_SLACK x the
    total time of its free-deadline solution, energy-heavy weights."""
    from repro_torch import Problem, Weights
    from repro_torch.core.energy import total_time

    deadline = DEADLINE_SLACK * total_time(fleet, free.allocation)[:, 0]
    return Problem(system=fleet, weights=Weights(*FIG8_WEIGHTS),
                   deadline=deadline), deadline


def phase_deadline_fleet(torch):
    """The deadline-constrained BCD at full width: the C=64 x N=2048
    float32 fleet, each cell's deadline from its free-deadline solve."""
    from repro_torch import Problem, SolverSpec, Weights, solve
    from repro_torch.core.energy import total_time

    fleet = fleet_system(torch, torch.float32)
    spec = SolverSpec(max_iters=FLEET_ITERS)

    def path():
        free = solve(Problem(system=fleet, weights=Weights(*WEIGHTS)), spec)
        problem, deadline = deadline_problem(torch, fleet, free)
        return solve(problem, spec), problem, deadline

    (res, problem, deadline), counts, reads, wall = counted(torch, path)
    solves = [counted_solve(torch, problem, spec) for _ in range(3)]
    feas = feasible_cells(torch, fleet, res.allocation)
    times = total_time(fleet, res.allocation)[:, 0].double()
    late = (times / deadline.double()).max().item()
    obj = res.objective.double()
    run = dict(C=FLEET_C, N=FLEET_N, dtype="float32", max_iters=FLEET_ITERS,
               weights=FIG8_WEIGHTS, deadline_slack=DEADLINE_SLACK,
               path_launches=counts, path_host_reads=reads, path_s=wall,
               iters=res.iters.cpu().tolist(),
               batched_iters=int(res.iters.max()),
               converged=int(res.converged.sum()), feasible=feas,
               max_time_over_deadline=late,
               deadline_s=[float(deadline.min()), float(deadline.max())],
               mean_energy=float(obj.mean()),
               objective_finite=bool(torch.isfinite(obj).all()),
               walls_s=[x[3] for x in solves],
               median_s=statistics.median(x[3] for x in solves),
               host_reads=solves[-1][2], launches=solves[-1][1],
               sp2_evals=res.counters.sp2_evals.double().mean().item())
    record("deadline_fleet", **run)
    check(run["objective_finite"] and all(feas.values()),
          f"deadline fleet: infeasible or non-finite result {feas}")
    check(late <= 1.05, f"deadline fleet: a cell runs {late:.4f} x its "
                        f"deadline (limit 1.05)")
    check(counts["sp1_lambda_sum"] > 0,
          "deadline fleet: sp1_lambda_sum never ran on the path")
    check(all(not any(x[1].values()) for x in solves),
          "deadline fleet: the deadline solve launched a kernel")
    return run


def pool_cells(torch, dtype, n_cells=None, device="cuda"):
    """The padded pool's first `n_cells` (default all FLEET_C) cells,
    unpadded, on `device` (PAD_SEED; see the constants), and their
    sizes."""
    from repro_torch import make_system

    sizes = torch.randint(PAD_N_LO, FLEET_N + 1, (FLEET_C,),
                          generator=torch.Generator().manual_seed(PAD_SEED))
    sizes = sizes.tolist()[:FLEET_C if n_cells is None else n_cells]
    gen = torch.Generator().manual_seed(PAD_SEED)
    cells = [make_system(gen, n, device=device, dtype=dtype,
                         bandwidth_total=20e6 * n / 50) for n in sizes]
    return cells, sizes


def padded_pool(torch, dtype, n_cells=None):
    """The padded pool's first `n_cells` (default all FLEET_C) cells
    (PAD_SEED; see the constants), each padded to bucket_size(N_c),
    stacked. Returns (pool, the unpadded cells, their sizes)."""
    from repro_torch import bucket_size, pad_system, stack_systems

    cells, sizes = pool_cells(torch, dtype, n_cells)
    check(all(bucket_size(n) == FLEET_N for n in sizes),
          "padded pool: a cell's bucket is not FLEET_N")
    pool = stack_systems([pad_system(c, bucket_size(n))
                          for c, n in zip(cells, sizes)])
    return pool, cells, sizes


def pad_lanes_neutral(torch, sysp, alloc):
    """(every pad lane's B is 0, every pad lane's energy is 0), exactly."""
    from repro_torch.core.energy import e_cmp, e_trans

    pad = ~sysp.active
    B = alloc.bandwidth[pad]
    e = (e_trans(sysp, alloc.bandwidth, alloc.power)
         + e_cmp(sysp, alloc.freq, alloc.resolution))[pad]
    return (torch.equal(B, torch.zeros_like(B)),
            torch.equal(e, torch.zeros_like(e)))


def phase_padded_fleet(torch):
    """A mixed-size pool padded onto one bucket and solved as one stack:
    feasible, pad lanes neutral, 3 SP1 launches per batched iteration; the
    first PAD_F64_CELLS cells re-solved unpadded in float64 against their
    padded float64 solves."""
    from repro_torch import Problem, SolverSpec, Weights, solve, \
        stack_systems

    pool, _, sizes = padded_pool(torch, torch.float32)
    spec = SolverSpec(max_iters=FLEET_ITERS)
    problem = Problem(system=pool, weights=Weights(*WEIGHTS))
    res, counts, reads, wall = counted_solve(torch, problem, spec)
    batched = int(res.iters.max())
    feas = feasible_cells(torch, pool, res.allocation)
    b_zero, e_zero = pad_lanes_neutral(torch, pool, res.allocation)
    _, _, _, wall2 = counted_solve(torch, problem, spec)

    pool64, cells64, _ = padded_pool(torch, torch.float64, PAD_F64_CELLS)
    r64 = solve(Problem(system=pool64, weights=Weights(*WEIGHTS)), spec)
    prefix_rel, same_iters = 0.0, True
    for c, cell in enumerate(cells64):
        one = solve(Problem(system=cell, weights=Weights(*WEIGHTS)), spec)
        same_iters &= one.iters == int(r64.iters[c])
        for f in ("bandwidth", "power", "freq", "resolution"):
            a = getattr(r64.allocation, f)[c, :cell.n]
            b = getattr(one.allocation, f)
            prefix_rel = max(prefix_rel,
                             float((a - b).abs().max() / b.abs().max()))
    obj = res.objective.double()
    run = dict(C=FLEET_C, N=FLEET_N, dtype="float32", max_iters=FLEET_ITERS,
               devices=[min(sizes), max(sizes)], real_devices=sum(sizes),
               first_call_s=wall, second_call_s=wall2, launches=counts,
               host_reads=reads, batched_iters=batched,
               iters=res.iters.cpu().tolist(),
               converged=int(res.converged.sum()), feasible=feas,
               pad_bandwidth_zero=b_zero, pad_energy_zero=e_zero,
               mean_objective=float(obj.mean()),
               objective_finite=bool(torch.isfinite(obj).all()),
               f64_cells=PAD_F64_CELLS, f64_prefix_max_rel_diff=prefix_rel,
               f64_same_iters=same_iters)
    record("padded_fleet", **run)
    check(run["objective_finite"] and all(feas.values()),
          f"padded fleet: infeasible or non-finite result {feas}")
    check(b_zero and e_zero, "padded fleet: a pad lane got bandwidth or "
                             "energy")
    check(counts["sp1_lambda_sum"] == 3 * batched,
          f"padded fleet: {counts['sp1_lambda_sum']} sp1_lambda_sum "
          f"launches for {batched} batched BCD iterations (want 3 each)")
    check(same_iters and prefix_rel <= PAD_PREFIX_TOL,
          f"padded fleet: float64 prefix vs unpadded solve rel diff "
          f"{prefix_rel:.3g} (limit {PAD_PREFIX_TOL:g}), same iterations "
          f"{same_iters}")
    return run


def phase_rounds_fleet(torch):
    """The main path's fleet through `solve(Problem(rounds=...))`: every
    round's allocation feasible (read off each round's BCD solve), the
    ledger finite, staleness codes in -1..K, arrived fractions in [0, 1],
    3 SP1 launches per batched BCD iteration of every round."""
    from repro_torch import Problem, RoundsConfig, Weights
    from repro_torch.core.types import Allocation
    from repro_torch.dynamics import engine

    fleet = fleet_system(torch, torch.float32)
    cfg = RoundsConfig(**ROUNDS)
    problem = Problem(system=fleet, weights=Weights(*WEIGHTS), rounds=cfg,
                      key=ROUNDS_SEED)
    solves, starts = [], []
    allocate = engine._allocate_impl

    def spy(*args, **kw):
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        out = allocate(*args, **kw)
        torch.cuda.synchronize()
        solves.append((time.perf_counter() - starts[-1], out[:4]))
        return out

    engine._allocate_impl = spy
    try:
        res, counts, reads, wall = counted_solve(torch, problem, None)
        end = time.perf_counter()
    finally:
        engine._allocate_impl = allocate
    round_s = [b - a for a, b in zip(starts, starts[1:] + [end])]
    feas = [feasible_cells(torch, fleet, Allocation(*out))
            for _, out in solves]
    iters = res.col("bcd_iters")                         # (C, R)
    batched = iters.amax(0).long().tolist()
    codes = res.staleness
    arrived = res.col("arrived_frac")
    sp2 = res.col("sp2_evals").double().mean(0).tolist()
    run = dict(C=FLEET_C, N=FLEET_N, dtype="float32", config=dict(ROUNDS),
               wall_s=wall, round_s=round_s,
               solve_s=[x[0] for x in solves], launches=counts,
               host_reads=reads, batched_iters=batched,
               mean_iters=iters.double().mean(0).tolist(),
               mean_sp2_evals=sp2,
               warm_rounds_fewer_sp2_evals=bool(max(sp2[1:]) < sp2[0]),
               ledger_finite=bool(torch.isfinite(res.ledger).all()),
               feasible_rounds=sum(all(f.values()) for f in feas),
               staleness_codes=[int(codes.min()), int(codes.max())],
               arrived_frac=[float(arrived.min()), float(arrived.max())],
               n_late=float(res.col("n_late").sum()),
               n_dropped=float(res.col("n_dropped").sum()),
               mean_objective=res.col("objective").double().mean(0).tolist())
    record("rounds_fleet", **run)
    check(run["ledger_finite"], "rounds fleet: non-finite ledger")
    check(run["feasible_rounds"] == cfg.rounds == len(solves),
          f"rounds fleet: {run['feasible_rounds']} of {cfg.rounds} rounds "
          f"feasible ({len(solves)} solves)")
    check(-1 <= run["staleness_codes"][0]
          and run["staleness_codes"][1] <= cfg.max_staleness,
          f"rounds fleet: staleness codes {run['staleness_codes']}")
    # under "stale" a round's arrivals are its on-time mass plus the late
    # mass of up to K earlier rounds at decay^k, so the fraction may pass 1
    # (as in repro); it stays under sum_{k <= K} decay^k
    top = sum(cfg.staleness_decay ** k for k in range(cfg.max_staleness + 1))
    check(0.0 <= run["arrived_frac"][0] and run["arrived_frac"][1] <= top,
          f"rounds fleet: arrived fractions {run['arrived_frac']} outside "
          f"[0, {top}]")
    check(counts["sp1_lambda_sum"] == 3 * sum(batched),
          f"rounds fleet: {counts['sp1_lambda_sum']} sp1_lambda_sum "
          f"launches for {sum(batched)} batched BCD iterations over "
          f"{cfg.rounds} rounds (want 3 each)")
    return run


def phase_grad(torch):
    """`repro_torch.diff.solve_and_grad` on the main path's fleet: values
    against `solve`'s, every gradient finite, the forward's SP1 launches;
    then a padded pool of PAD_F64_CELLS cells, whose pad lanes' gradients
    must be exactly 0."""
    from repro_torch import Problem, SolverSpec, Weights, solve
    from repro_torch.core.bcd import _LEDGER_COLS
    from repro_torch.diff import METRICS, solve_and_grad

    fleet = fleet_system(torch, torch.float32)
    spec = SolverSpec(max_iters=FLEET_ITERS)
    problem = Problem(system=fleet, weights=Weights(*WEIGHTS))
    g, counts, reads, wall = counted(
        torch, lambda: solve_and_grad(problem, spec, adjoint_iters=30))
    res = solve(problem, spec)
    last = res.history[torch.arange(FLEET_C, device=res.iters.device),
                       res.iters.long() - 1]
    value_rel = {}
    for m in ("objective", "energy", "time"):
        ref = last[:, _LEDGER_COLS.index(m)].double()
        value_rel[m] = float(((g.value[m].double() - ref).abs()
                              / ref.abs()).max())
    finite = all(bool(torch.isfinite(v).all())
                 for d in g.grads.values() for v in d.values())
    batched = int(res.iters.max())

    pool, _, _ = padded_pool(torch, torch.float32, PAD_F64_CELLS)
    gp = solve_and_grad(Problem(system=pool, weights=Weights(*WEIGHTS)),
                        spec, wrt=("gain", "cycles", "samples", "kappa"))
    pad = ~pool.active
    pad_zero = all(torch.equal(gp.grads[m][k][pad],
                               torch.zeros_like(gp.grads[m][k][pad]))
                   for m in METRICS for k in ("gain", "cycles", "samples"))
    run = dict(C=FLEET_C, N=FLEET_N, dtype="float32", adjoint_iters=30,
               wrt=list(g.wrt), wall_s=wall, launches=counts,
               host_reads=reads, batched_iters=batched,
               value_max_rel_diff=value_rel, value_tol=GRAD_VALUE_TOL,
               grads_finite=finite,
               grad_objective_weights_mean=g.grads["objective"]["weights"]
               .double().mean(0).tolist(),
               padded_cells=PAD_F64_CELLS, pad_lane_grads_zero=pad_zero)
    record("grad", **run)
    check(max(value_rel.values()) <= GRAD_VALUE_TOL,
          f"grad: values differ from solve()'s by {value_rel}")
    check(finite, "grad: a non-finite gradient")
    check(pad_zero, "grad: a pad lane's gradient is not exactly 0")
    check(counts["sp1_lambda_sum"] == 3 * batched,
          f"grad: {counts['sp1_lambda_sum']} sp1_lambda_sum launches for "
          f"{batched} batched BCD iterations of the forward solve")
    return run


def serve_trace(torch, n_cells, n_requests, dtype):
    """Trace (a), examples/region_serve.py's: `n_cells` cells with pools
    drawn from SERVE_POOLS and per-cell weights (numpy seed SERVE_SEED),
    systems from seed SERVE_SEED * 1000 + cell, built on the host; Poisson
    ticks of SERVE_RATE distinct cells, each request's gains drifted by
    SERVE_DRIFT since that cell's last request; `n_requests` in all.
    Returns the ticks, each a list of AllocationRequests."""
    import numpy as np

    from repro_torch import AllocationRequest, Weights, make_system

    rng = np.random.default_rng(SERVE_SEED)
    pools = rng.choice(SERVE_POOLS, size=n_cells)
    cells, weights = {}, {}
    for cid in range(n_cells):
        cells[cid] = make_system(SERVE_SEED * 1000 + cid, int(pools[cid]),
                                 device="cpu", dtype=dtype)
        w1 = float(rng.uniform(0.1, 0.9))
        weights[cid] = Weights(w1, 1.0 - w1, float(rng.uniform(1.0, 30.0)))
    ticks, sent = [], 0
    while sent < n_requests:
        k = min(int(rng.poisson(SERVE_RATE)), n_requests - sent, n_cells)
        tick = []
        for cid in rng.choice(n_cells, size=k, replace=False):
            cid = int(cid)
            sysc = cells[cid]
            drift = np.abs(1.0 + SERVE_DRIFT * rng.standard_normal(sysc.n))
            cells[cid] = sysc.replace(
                gain=sysc.gain * torch.from_numpy(drift).to(dtype))
            tick.append(AllocationRequest(cell_id=cid, sys=cells[cid],
                                          w=weights[cid]))
        ticks.append(tick)
        sent += k
    return ticks


def serve(pipe, ticks):
    """Replay `ticks` through a RegionPipeline as fast as it takes them:
    submit a tick's requests and `poll()` (the admission policy closes
    full batches); drain at the end. Returns (the futures in submission
    order, the dispatched batches)."""
    futs, batches = [], []
    for tick in ticks:
        futs += [pipe.submit(r) for r in tick]
        batches += pipe.poll()
    batches += pipe.pump(force=True)
    pipe.drain()
    return futs, batches


def serve_pipeline(depth=None, device="cuda"):
    """A RegionPipeline at SERVE_CPB cells a batch, buckets from
    SERVE_MIN_BUCKET, SERVE_SPEC, depth SERVE_DEPTH unless given."""
    from repro_torch import RegionPipeline, SolverSpec, Weights

    return RegionPipeline(
        Weights(*WEIGHTS), cells_per_batch=SERVE_CPB,
        min_bucket=SERVE_MIN_BUCKET, spec=SolverSpec(**SERVE_SPEC),
        max_in_flight=SERVE_DEPTH if depth is None else depth, device=device)


def same_responses(torch, futs_a, futs_b):
    """Two runs' responses are equal field for field, to the bit."""
    def same(a, b):
        return (a.cell_id, a.iters, a.warm, a.objective) \
            == (b.cell_id, b.iters, b.warm, b.objective) and all(
                torch.equal(getattr(a.allocation, k), getattr(b.allocation, k))
                for k in ("bandwidth", "power", "freq", "resolution",
                          "s_relaxed", "T"))

    return len(futs_a) == len(futs_b) and all(
        same(a.result(), b.result()) for a, b in zip(futs_a, futs_b))


def served_record(torch, label, pipe, futs, batches, counts, reads, wall):
    """The record of one served trace: throughput, latency (the metric
    plane's histogram since the last registry reset), stage clocks,
    batches and their shapes, warm starts, launches and host reads per
    batch, and every response's feasibility (on its unpadded allocation,
    against its own request)."""
    from repro_torch import obs

    resp = [f.result() for f in futs]
    feas = [feasible_cells(torch, f.request.sys, r.allocation)
            for f, r in zip(futs, resp)]
    warm = [r.iters for r in resp if r.warm]
    cold = [r.iters for r in resp if not r.warm]
    lat = obs.histogram("region_request_latency_seconds")
    clocks = {s: dict(total_s=pipe.clocks.total(s), n=pipe.clocks.count(s),
                      **pipe.clocks.percentiles(s, (50.0, 99.0)))
              for s in pipe.clocks.STAGES}
    batched = [int(b.result.iters.max()) for b in batches]
    rec = dict(
        trace=label, requests=len(resp), wall_s=wall,
        requests_per_s=len(resp) / wall,
        latency_p50_s=lat.percentile(50.0), latency_p99_s=lat.percentile(99.0),
        latency_count=lat.count, stage_clocks=clocks,
        batches=len(batches), shapes=sorted(pipe.compiled_shapes),
        batched_iters=batched, cache=dict(hits=pipe.cache.hits,
                                          misses=pipe.cache.misses),
        warm_solves=len(warm), cold_solves=len(cold),
        mean_warm_iters=statistics.mean(warm) if warm else None,
        mean_cold_iters=statistics.mean(cold) if cold else None,
        warm_share_le3=(sum(i <= 3 for i in warm) / len(warm)) if warm
        else None,
        launches=counts, host_reads=reads,
        sp1_launches_per_batch=counts["sp1_lambda_sum"] / len(batches),
        host_reads_per_batch=reads / len(batches),
        feasible=sum(all(f.values()) for f in feas),
        finite=sum(math.isfinite(r.objective) for r in resp))
    record("region_serve", **rec)
    check(rec["feasible"] == rec["finite"] == len(resp),
          f"region serve {label}: {len(resp) - rec['feasible']} infeasible "
          f"and {len(resp) - rec['finite']} non-finite responses")
    check(counts["sp1_lambda_sum"] == 3 * sum(batched),
          f"region serve {label}: {counts['sp1_lambda_sum']} sp1_lambda_sum "
          f"launches for {sum(batched)} batched BCD iterations over "
          f"{len(batches)} batches (want 3 each)")
    return rec


def serve_trace_a(torch):
    """Trace (a) on the card, with the metric plane's checks: every
    response counted, the default SLOs' verdicts, a scrape that parses."""
    import urllib.request

    from repro_torch import obs

    obs.REGISTRY.reset()
    plane = obs.SloPlane(obs.default_slos())
    plane.observe()
    ticks = serve_trace(torch, SERVE_CELLS, SERVE_REQUESTS, torch.float32)
    pipe = serve_pipeline()
    (futs, batches), counts, reads, wall = counted(
        torch, lambda: serve(pipe, ticks))
    rec = served_record(torch, "a_region", pipe, futs, batches, counts,
                        reads, wall)
    check(len(futs) == SERVE_REQUESTS,
          f"region serve (a): {len(futs)} responses for {SERVE_REQUESTS}")
    check(len(rec["shapes"]) <= 4,
          f"region serve (a): {len(rec['shapes'])} batch shapes (max 4)")
    served = obs.counter("region_solve_cells").value
    verdicts = plane.check()
    with obs.MetricsServer(slo_plane=plane) as srv:
        check(srv.host == "127.0.0.1", "metrics server not on loopback")
        with urllib.request.urlopen(srv.url("/metrics"), timeout=30) as r:
            scraped = obs.parse_prometheus_text(r.read().decode())
    record("region_serve", trace="a_region", metric_plane=dict(
        region_solve_cells=served, latency_count=rec["latency_count"],
        slo_verdicts={v["name"]: v["verdict"] for v in verdicts},
        scraped_series=len(scraped),
        scraped_solve_cells=scraped.get(("region_solve_cells_total", ()))))
    check(served == rec["latency_count"] == SERVE_REQUESTS,
          f"region serve (a): the metric plane counts {served} solved cells "
          f"and {rec['latency_count']} latencies for {SERVE_REQUESTS}")
    check([v["name"] for v in verdicts] == ["serve_latency_p99",
                                            "deadline_hit_rate",
                                            "bcd_convergence"]
          and all(v["verdict"] in ("ok", "warn", "breach", "no_data")
                  for v in verdicts), f"region serve: SLO verdicts {verdicts}")
    check(scraped.get(("region_solve_cells_total", ())) == served,
          "region serve: the /metrics scrape disagrees with the registry")
    return counts["sp1_lambda_sum"]


def serve_pool_b(torch):
    """Trace (b): the padded pool's 64 cells as cold requests (recorded),
    a warm wave with 1% drift, the cold wave again at depth 1, one batch
    solved directly on its plan (traced with torch.profiler)."""
    import numpy as np

    from repro_torch import AllocationRequest, Problem, SolverSpec, obs, \
        solve

    cells, sizes = pool_cells(torch, torch.float32, device="cpu")
    cold = [AllocationRequest(cell_id=c, sys=s) for c, s in enumerate(cells)]
    rng = np.random.default_rng(SERVE_SEED)
    warm = [AllocationRequest(cell_id=c, sys=s.replace(
        gain=s.gain * torch.from_numpy(np.abs(
            1.0 + SERVE_DRIFT * rng.standard_normal(s.n))).float()))
        for c, s in enumerate(cells)]
    obs.REGISTRY.reset()
    pipe = serve_pipeline()
    events = obs.MemoryRecorder()
    with obs.recording(events):
        (futs, batches), counts, reads, wall = counted(
            torch, lambda: serve(pipe, [cold]))
    rec_c = served_record(torch, "b_pool_cold", pipe, futs, batches, counts,
                          reads, wall)
    obs.REGISTRY.reset()
    (futs_w, batches_w), counts_w, reads_w, wall_w = counted(
        torch, lambda: serve(pipe, [warm]))
    rec_w = served_record(torch, "b_pool_warm", pipe, futs_w, batches_w,
                          counts_w, reads_w, wall_w)
    names = {e["name"] for e in events.events}
    n_points = sum(e["name"] == "request" for e in events.events)
    check({"plan", "dispatch", "materialize", "solve"} <= names
          and n_points == len(cold),
          f"region serve (b): recorded events {sorted(names)}, {n_points} "
          f"request points for {len(cold)} responses")
    check(rec_w["warm_solves"] == len(warm)
          and rec_w["mean_warm_iters"] < rec_c["mean_cold_iters"],
          f"region serve (b): warm wave {rec_w['warm_solves']} warm, mean "
          f"{rec_w['mean_warm_iters']} iterations vs cold "
          f"{rec_c['mean_cold_iters']}")

    pipe1 = serve_pipeline(depth=1)
    futs1, _ = serve(pipe1, [cold])
    same_depth = same_responses(torch, futs1, futs)

    plan = batches[0].plan
    res = solve(Problem(system=plan.sys_batch, weights=plan.weights,
                        init=plan.init_batch), SolverSpec(**SERVE_SPEC))
    direct_same = True
    for lane, f in enumerate(futs[:plan.n_real]):
        r, n = f.result(), f.request.sys.n
        direct_same &= r.iters == int(res.iters[lane])
        for k in ("bandwidth", "power", "freq", "resolution"):
            direct_same &= torch.equal(getattr(r.allocation, k),
                                       getattr(res.allocation, k)[lane, :n]
                                       .cpu())
    record("region_serve", trace="b_pool", C=SERVE_CPB, bucket=FLEET_N,
           cells=len(cells), devices=[min(sizes), max(sizes)],
           depth1_bitwise=same_depth, direct_solve_bitwise=direct_same,
           recorded_events=len(events.events), request_points=n_points)
    check(same_depth, "region serve (b): depth 1 and depth 2 responses "
                      "differ")
    check(direct_same, "region serve (b): the direct solve of a batch's plan "
                       "differs from its served responses")
    return counts["sp1_lambda_sum"] + counts_w["sp1_lambda_sum"]


def trace_served_batch(torch):
    """One batch of trace (b) (the pool's first SERVE_CPB cells, cold)
    served under torch.profiler with a recorder on: the card's idle share,
    and every sp1_lambda_sum kernel inside the `solve` span's range (each
    call runs two kernels, its partial and its final sums; 3 calls a
    batched BCD iteration)."""
    from repro_torch import AllocationRequest, obs

    cells, _ = pool_cells(torch, torch.float32, SERVE_CPB, device="cpu")
    cold = [AllocationRequest(cell_id=c, sys=s) for c, s in enumerate(cells)]
    pipe = serve_pipeline()
    with obs.recording(obs.MemoryRecorder()):
        ((futs, batches), counts, reads, _), rec = trace_call(
            torch, lambda: counted(torch, lambda: serve(pipe, [cold])),
            within="solve")
    batched = int(batches[0].result.iters.max())
    sp1_in = rec["within"]["sp1_lambda_sum"]
    record("profile", topology="region_serve_batch", C=SERVE_CPB,
           N=FLEET_N, dtype="float32", batches=len(batches),
           batched_iters=batched, host_reads=reads, launches=counts, **rec)
    check(len(batches) == 1 and sp1_in["inside"] == 2 * 3 * batched
          and sp1_in["outside"] == 0,
          f"region serve: the traced batch's solve range holds "
          f"{sp1_in['inside']} sp1_lambda_sum kernels ({sp1_in['outside']} "
          f"outside it) for {batched} batched iterations (want 2 x 3 each)")


def serve_mesh(torch):
    """`Problem.mesh` on the C=64 x N=2048 fleet: shard-local and lockstep
    over `region_mesh()` equal the plain fleet solve bit for bit; the one
    shard's counters equal the fleet's sums."""
    from repro_torch import Problem, SolverSpec, Weights, region_mesh, solve

    fleet = fleet_system(torch, torch.float32)
    spec = SolverSpec(max_iters=FLEET_ITERS)
    mesh = region_mesh()
    base, counts, reads, wall = counted_solve(
        torch, Problem(system=fleet, weights=Weights(*WEIGHTS)), spec)
    sums = base.counters.data.double().sum(0).tolist()
    out = {}
    for lockstep in (False, True):
        reg, counts_m, reads_m, wall_m = counted_solve(
            torch, Problem(system=fleet, weights=Weights(*WEIGHTS),
                           mesh=mesh), spec.replace(lockstep=lockstep))
        same = all(torch.equal(getattr(reg.allocation, k),
                               getattr(base.allocation, k))
                   for k in ("bandwidth", "power", "freq", "resolution",
                             "s_relaxed", "T")) \
            and torch.equal(reg.iters, base.iters) \
            and torch.equal(reg.objective, base.objective)
        st = reg.stats
        shard = [st["shard_bcd_iters"], st["shard_sp1_evals"],
                 st["shard_sp2_evals"]]
        out["lockstep" if lockstep else "shard_local"] = dict(
            bitwise=same, wall_s=wall_m, launches=counts_m,
            host_reads=reads_m, mesh_devices=st["mesh_devices"],
            shard_counters=shard)
        check(same, f"region mesh (lockstep={lockstep}): differs from the "
                    f"fleet solve")
        check(st["mesh_devices"] == mesh.size == 1
              and [s[0] for s in shard] == sums[:3],
              f"region mesh: shard counters {shard} vs fleet sums "
              f"{sums[:3]}")
    record("region_serve", trace="mesh", C=FLEET_C, N=FLEET_N,
           devices=[str(d) for d in mesh.devices], fleet_wall_s=wall,
           fleet_counter_sums=sums[:3], **out)


class CheckedService:
    """A RegionAllocator whose `solve` also holds every response to its
    request (finite, feasible on the unpadded allocation)."""

    def __init__(self, torch, svc):
        self.torch, self.svc, self.bad, self.n = torch, svc, 0, 0

    def solve(self, reqs):
        out = self.svc.solve(reqs)
        for r in reqs:
            resp = out[r.cell_id]
            feas = feasible_cells(self.torch, r.sys, resp.allocation)
            self.bad += not (all(feas.values())
                             and math.isfinite(resp.objective))
            self.n += 1
        return out

    def invalidate(self, cell_id):
        return self.svc.invalidate(cell_id)

    @property
    def stats(self):
        return self.svc.stats

    @property
    def compiled_shapes(self):
        return self.svc.compiled_shapes


def serve_mobility(torch):
    """Trace (c): `replay_mobility` of a random-waypoint trace over
    MOB_CELLS cells of the port's bs_grid through a RegionAllocator."""
    from repro_torch import (MobilityConfig, RegionAllocator, SolverSpec,
                             Weights, make_system, obs, replay_mobility,
                             simulate_mobility)

    cfg = MobilityConfig(**MOB_CFG)
    trace = simulate_mobility(MOB_SEED, MOB_DEVICES, MOB_CELLS, cfg,
                              device="cuda")
    base = make_system(MOB_SEED, MOB_DEVICES, device="cpu",
                       bandwidth_total=20e6 * MOB_DEVICES / MOB_CELLS / 50)
    svc = CheckedService(torch, RegionAllocator(
        Weights(*WEIGHTS), cells_per_batch=MOB_CELLS,
        min_bucket=MOB_MIN_BUCKET, spec=SolverSpec(**SERVE_SPEC),
        pipeline_depth=SERVE_DEPTH, device="cuda"))
    obs.REGISTRY.reset()
    rep, counts, reads, wall = counted(
        torch, lambda: replay_mobility(svc, trace, base))
    lat = obs.histogram("region_request_latency_seconds")
    sizes = torch.stack([torch.bincount(row.long(), minlength=MOB_CELLS)
                         for row in trace.serving])       # (R, C)
    batches = svc.stats["batches"]
    record("region_serve", trace="c_mobility", config=dict(MOB_CFG),
           wall_s=wall,
           requests_per_s=rep["requests"] / wall,
           latency_p50_s=lat.percentile(50.0),
           latency_p99_s=lat.percentile(99.0), launches=counts,
           host_reads=reads, batches=batches,
           sp1_launches_per_batch=counts["sp1_lambda_sum"] / batches,
           host_reads_per_batch=reads / batches,
           cell_sizes=[int(sizes.min()), int(sizes.max())],
           stage_clocks=svc.svc.clocks.as_dict(), infeasible=svc.bad,
           **{k: v for k, v in rep.items()})
    check(svc.bad == 0 and svc.n == rep["requests"] > 0,
          f"region serve (c): {svc.bad} of {svc.n} responses infeasible or "
          f"non-finite")
    check(rep["handover_purges"] <= 2 * rep["handovers"]
          and rep["warm_solves"] + rep["cold_solves"] == rep["requests"],
          f"region serve (c): churn summary {rep}")
    check(counts["sp1_lambda_sum"] > 0, "region serve (c): sp1_lambda_sum "
                                        "never ran")
    return counts["sp1_lambda_sum"]


def serve_card_vs_cpu(torch):
    """Trace (a) cut to its first SERVE_CPU_CELLS cells and
    SERVE_CPU_REQUESTS requests, float64, served on the card and on the
    CPU: the same responses to 1e-8, iterations, warm flags, buckets and
    serving tallies; summed SP2 evals within EV_SLACK_PER_ITER a BCD
    iteration (ROADMAP Queue 3)."""
    ticks = serve_trace(torch, SERVE_CPU_CELLS, SERVE_CPU_REQUESTS,
                        torch.float64)
    runs = {}
    for device in ("cuda", "cpu"):
        pipe = serve_pipeline(device=device)
        t0 = time.perf_counter()
        futs, _ = serve(pipe, ticks)
        runs[device] = ([f.result() for f in futs], pipe.stats,
                        time.perf_counter() - t0)
    (rg, sg, tg), (rc, sc, tc) = runs["cuda"], runs["cpu"]
    rel = 0.0
    same = len(rg) == len(rc)
    for a, b in zip(rg, rc):
        same &= (a.cell_id, a.iters, a.warm, a.bucket, a.converged) \
            == (b.cell_id, b.iters, b.warm, b.bucket, b.converged)
        rel = max(rel, abs(a.objective - b.objective) / abs(b.objective))
        for k in ("bandwidth", "power", "freq", "resolution"):
            x, y = getattr(a.allocation, k), getattr(b.allocation, k)
            rel = max(rel, float((x - y).abs().max() / y.abs().max()))
    keys = ("requests", "batches", "shapes", "cache_hits", "cache_misses",
            "handover_purges", "cells_solved", "cells_converged")
    same_stats = all(sg[k] == sc[k] for k in keys)
    cg, cc = sg["solver_counters"], sc["solver_counters"]
    ev_gap = abs(cg["sp2_evals"] - cc["sp2_evals"])
    record("card_vs_cpu", topology="region_serve", cells=SERVE_CPU_CELLS,
           requests=len(rc), dtype="float64", max_rel_diff=rel,
           same_responses=same, same_stats=same_stats,
           stats={k: sorted(sc[k]) if k == "shapes" else sc[k]
                  for k in keys},
           bcd_iters=[cg["bcd_iters"], cc["bcd_iters"]],
           sp2_evals=[cg["sp2_evals"], cc["sp2_evals"]], card_s=tg,
           cpu_s=tc)
    check(same and rel <= 1e-8,
          f"card vs CPU, region serve: responses differ (rel {rel:.3g}, "
          f"same fields {same})")
    check(same_stats and cg["bcd_iters"] == cc["bcd_iters"]
          and cg["sp1_evals"] == cc["sp1_evals"],
          "card vs CPU, region serve: serving tallies differ")
    check(ev_gap <= EV_SLACK_PER_ITER * cc["bcd_iters"],
          f"card vs CPU, region serve: sp2_evals differ by {ev_gap}")


def phase_region_serve(torch):
    """The region serving stack on the card: traces (a), (b) and (c), the
    mesh, and trace (a) cut to 12 cells card vs CPU in float64."""
    launches = serve_trace_a(torch)
    launches += serve_pool_b(torch)
    serve_mesh(torch)
    launches += serve_mobility(torch)
    serve_card_vs_cpu(torch)
    return dict(launches=dict(sp1_lambda_sum=launches))


def grad_rel(torch, a, b):
    """The largest differences of two GradResults' values and of their
    gradients, each relative to the array's largest entry: (values,
    gradients)."""
    def rel(x, y):
        x, y = x.double().cpu(), y.double().cpu()
        return float((x - y).abs().max() / y.abs().max().clamp_min(1e-300))

    return (max(rel(a.value[m], b.value[m]) for m in a.value),
            max(rel(a.grads[m][k], b.grads[m][k])
                for m in a.grads for k in a.grads[m]))


class _CardLog1p:
    """torch, with log1p evaluated on the card (a stand-in for the `torch`
    module inside `core.sp2` while an SP2 search is replayed)."""

    def __init__(self, torch):
        self._torch = torch

    def __getattr__(self, name):
        return getattr(self._torch, name)

    def log1p(self, x):
        return self._torch.log1p(x.cuda()).cpu()


def sp2_gap(torch, calls, iters):
    """The SP2 search (round, BCD iteration, cell) with the largest eval
    gap between the card's and the CPU's rounds runs, and replays of it:
    on the CPU with the card's inputs; on the card again; on the CPU with
    the CPU's inputs and the card's exp; and with the card's exp and
    log1p. `calls` holds each run's (system, rmin, evals) per SP2 search
    in order; `iters` (C, R) the BCD iterations of each cell and round."""
    from repro_torch.core import sp2

    card, cpu = calls["card"], calls["cpu"]
    batched = iters.amax(0).long().tolist()
    where = [(r, k) for r, n in enumerate(batched) for k in range(n)]
    gaps = torch.stack([(a[2].cpu().long() - b[2].long()).abs()
                        for a, b in zip(card, cpu)])           # (calls, C)
    i, c = divmod(int(gaps.argmax()), gaps.shape[1])
    (sys_g, rmin_g, ev_g), (sys_c, rmin_c, ev_c) = card[i], cpu[i]

    def evals(sysp, rmin):
        return int(sp2._sp2_direct_impl(sysp, rmin)[2][c])

    def rel(a, b):
        a, b = a.cpu()[c].double(), b.cpu()[c].double()
        return float((a - b).abs().max() / b.abs().max())

    exp2 = sp2._exp2
    replay = dict(cpu_with_card_inputs=evals(sys_g.to("cpu"), rmin_g.cpu()),
                  card_again=evals(sys_g, rmin_g))
    try:
        sp2._exp2 = lambda x: torch.exp((x * sp2._LN2).cuda()).cpu()
        replay["cpu_inputs_card_exp"] = evals(sys_c, rmin_c)
        sp2.torch = _CardLog1p(torch)
        replay["cpu_inputs_card_exp_log1p"] = evals(sys_c, rmin_c)
    finally:
        sp2._exp2 = exp2
        sp2.torch = torch
    r, k = where[i] if i < len(where) else (None, None)
    return dict(round=r, bcd_iteration=None if k is None else k + 1,
                cell=c, sp2_search=i, gap=int(gaps[i, c]),
                evals_card=int(ev_g[c]), evals_cpu=int(ev_c[c]),
                cell_bcd_iters=None if r is None else int(iters[c, r]),
                gaps_per_search=gaps.amax(1).tolist(),
                rmin_rel_diff=rel(rmin_g, rmin_c),
                gain_rel_diff=rel(sys_g.gain, sys_c.gain), replay=replay)


def card_vs_cpu_dynamics(torch):
    """Rounds and solve_and_grad on the card and on the CPU in float64."""
    from repro_torch import (Problem, RoundsConfig, SolverSpec, Weights,
                             make_system, solve)
    from repro_torch.core import bcd
    from repro_torch.diff import implicit, solve_and_grad
    from repro_torch.dynamics import ROUND_COLS, draws_from_generator

    weights = Weights(*WEIGHTS)
    four = fleet_system(torch, torch.float64, 4, CPU_N)
    cfg = RoundsConfig(**CPU_ROUNDS)
    draws = draws_from_generator(ROUNDS_SEED, 4, cfg.rounds, CPU_N, cfg,
                                 device="cuda", dtype=torch.float64)
    calls = {}
    sp2_impl = bcd._sp2_direct_impl

    def spy(tag):
        def run(sysp, rmin, *a, **kw):
            out = sp2_impl(sysp, rmin, *a, **kw)
            calls.setdefault(tag, []).append((sysp, rmin, out[2]))
            return out
        return run

    try:
        bcd._sp2_direct_impl = spy("card")
        gpu = solve(Problem(system=four, weights=weights, rounds=cfg,
                            key=draws))
        bcd._sp2_direct_impl = spy("cpu")
        cpu = solve(Problem(system=four.to("cpu"), weights=weights,
                            rounds=cfg, key=draws.to("cpu")))
    finally:
        bcd._sp2_direct_impl = sp2_impl
    lg, lc = gpu.ledger.cpu(), cpu.ledger
    ev = ROUND_COLS.index("sp2_evals")
    cols = [i for i in range(len(ROUND_COLS)) if i != ev]
    scale = lc[..., cols].abs().amax((0, 1)).clamp_min(1e-300)
    ledger_rel = float(((lg[..., cols] - lc[..., cols]).abs()
                        / scale).max())
    ev_gap = float((lg[..., ev] - lc[..., ev]).abs().max())
    iters = lc[..., ROUND_COLS.index("bcd_iters")]
    same_iters = torch.equal(lg[..., ROUND_COLS.index("bcd_iters")], iters)
    same_codes = torch.equal(gpu.staleness.cpu(), cpu.staleness)
    gap_at = (lg[..., ev] - lc[..., ev]).abs()                 # (C, R)
    worst = divmod(int(gap_at.argmax()), gap_at.shape[1])
    record("card_vs_cpu", topology="rounds", C=4, N=CPU_N, dtype="float64",
           config=CPU_ROUNDS, n_late=float(gpu.col("n_late").sum()),
           ledger_max_rel_diff=ledger_rel,
           sp2_evals_max_gap=ev_gap,
           sp2_evals_max_gap_at=dict(
               cell=worst[0], round=worst[1],
               bcd_iters=float(iters[worst]),
               bound=EV_SLACK_PER_ITER * float(iters[worst])),
           same_bcd_iters=same_iters, same_staleness=same_codes)
    if same_iters:
        record("card_vs_cpu", topology="rounds_sp2_gap",
               **sp2_gap(torch, calls, iters.long()))
    check(same_iters, "card vs CPU, rounds: BCD iteration counts differ")
    check(same_codes, "card vs CPU, rounds: staleness codes differ")
    check(ledger_rel <= 1e-8, f"card vs CPU, rounds: ledger rel diff "
                              f"{ledger_rel:.3g} > 1e-8")
    check(bool(((lg[..., ev] - lc[..., ev]).abs()
                <= EV_SLACK_PER_ITER * iters).all()),
          f"card vs CPU, rounds: sp2_evals differ by {ev_gap}")

    spec = SolverSpec(max_iters=FLEET_ITERS)
    gg = solve_and_grad(Problem(system=four, weights=weights), spec)
    cpu4 = four.to("cpu")
    gc = solve_and_grad(Problem(system=cpu4, weights=weights), spec)
    ulp = solve_and_grad(Problem(system=cpu4.replace(
        gain=cpu4.gain * (1 + torch.finfo(torch.float64).eps)),
        weights=weights), spec)
    val4, grad4 = grad_rel(torch, gg, gc)
    spread4 = grad_rel(torch, ulp, gc)[1]
    cell = make_system(PAPER_SEED, n_devices=PAPER_N, device="cuda",
                       dtype=torch.float64)
    dg = solve_and_grad(Problem(system=cell, weights=weights), SolverSpec(),
                        adjoint_iters=0)
    dense = implicit._dense_adjoint
    conds = []

    def spy(ctx, x, pull_x, v):
        u = dense(ctx, x, pull_x, v)
        n = 2 * x[0].shape[1]
        conds.append(float(torch.linalg.cond(
            torch.eye(n, dtype=x[0].dtype, device=x[0].device)
            - ctx.jac.transpose(-1, -2)).max()))
        return u

    implicit._dense_adjoint = spy
    try:
        dc = solve_and_grad(Problem(system=cell.to("cpu"), weights=weights),
                            SolverSpec(), adjoint_iters=0)
    finally:
        implicit._dense_adjoint = dense
    val1, grad1 = grad_rel(torch, dg, dc)
    record("card_vs_cpu", topology="grad", C=4, N=CPU_N, dtype="float64",
           adjoint_iters=30, value_max_rel_diff=val4,
           grad_max_rel_diff=grad4, cpu_ulp_spread=spread4,
           grad_tol=GRAD_CPU_TOL)
    record("card_vs_cpu", topology="grad_dense", N=PAPER_N, dtype="float64",
           adjoint_iters=0, value_max_rel_diff=val1,
           grad_max_rel_diff=grad1, cond_I_minus_JT=max(conds),
           grad_tol=DENSE_CPU_TOL)
    check(max(val4, val1) <= 1e-8,
          f"card vs CPU, solve_and_grad: values differ by "
          f"{max(val4, val1):.3g} > 1e-8")
    check(grad4 <= GRAD_CPU_TOL,
          f"card vs CPU, solve_and_grad on 4 cells: gradients differ by "
          f"{grad4:.3g} > {GRAD_CPU_TOL:g} (the CPU's one-ulp spread "
          f"{spread4:.3g})")
    check(grad1 <= DENSE_CPU_TOL,
          f"card vs CPU, dense adjoint on the paper cell: gradients differ "
          f"by {grad1:.3g} > {DENSE_CPU_TOL:g}")


def phase_card_vs_cpu(torch):
    """Four fleet cells and the paper cell in float64, solved on the card
    and on the CPU."""
    from repro_torch import (Problem, SolverSpec, Weights, make_system, solve,
                             stack_systems)

    cell = make_system(PAPER_SEED, n_devices=PAPER_N, device="cuda",
                       dtype=torch.float64)
    weights = Weights(*WEIGHTS)
    gpu1 = solve(Problem(system=cell, weights=weights), SolverSpec())
    cpu1 = solve(Problem(system=cell.to("cpu"), weights=weights),
                 SolverSpec())
    rel1 = abs(gpu1.objective - cpu1.objective) / abs(cpu1.objective)
    record("card_vs_cpu", topology="single", N=PAPER_N, dtype="float64",
           objective_card=gpu1.objective, objective_cpu=cpu1.objective,
           rel_diff=rel1, iters_card=gpu1.iters, iters_cpu=cpu1.iters)
    check(rel1 <= 1e-8,
          f"card vs CPU, paper cell: objective rel diff {rel1:.3g} > 1e-8")
    check(gpu1.iters == cpu1.iters,
          "card vs CPU, paper cell: BCD iteration counts differ")

    fleet = fleet_system(torch, torch.float64)
    four = stack_systems([fleet.cell(c) for c in range(4)])
    spec = SolverSpec(max_iters=FLEET_ITERS)
    gpu = solve(Problem(system=four, weights=weights), spec)
    t0 = time.perf_counter()
    cpu = solve(Problem(system=four.to("cpu"), weights=weights), spec)
    cpu_s = time.perf_counter() - t0
    og, oc = gpu.objective.cpu(), cpu.objective
    rel = float(((og - oc).abs() / oc.abs()).max())
    record("card_vs_cpu", C=4, N=FLEET_N, dtype="float64",
           objective_card=og.tolist(), objective_cpu=oc.tolist(),
           max_rel_diff=rel, iters_card=gpu.iters.tolist(),
           iters_cpu=cpu.iters.tolist(), cpu_solve_s=cpu_s)
    check(rel <= 1e-8, f"card vs CPU: objective rel diff {rel:.3g} > 1e-8")
    check(torch.equal(gpu.iters.cpu(), cpu.iters),
          "card vs CPU: BCD iteration counts differ")
    card_vs_cpu_dynamics(torch)


def phase_paper_paths(torch):
    """The engines and topologies of this slice in float64, card vs CPU:
    objectives to 1e-8 relative and equal BCD iterations."""
    from repro_torch import Problem, SolverSpec, Weights, make_system, solve
    from repro_torch.core.accuracy import log_fit
    from repro_torch.core.types import dbm_to_watt

    rows = []

    def compare(label, problem, spec):
        cpu_problem = Problem(
            system=problem.system.to("cpu"), weights=problem.weights,
            acc=problem.acc, deadline=problem.deadline
            if not torch.is_tensor(problem.deadline)
            else problem.deadline.cpu())
        t0 = time.perf_counter()
        gpu = solve(problem, spec)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = solve(cpu_problem, spec)
        cpu_s = time.perf_counter() - t0
        if isinstance(gpu.objective, float):
            og = torch.tensor([gpu.objective], dtype=torch.float64)
            oc = torch.tensor([cpu.objective], dtype=torch.float64)
            ig, ic = [gpu.iters], [cpu.iters]
        else:
            og, oc = gpu.objective.cpu(), cpu.objective
            ig, ic = gpu.iters.cpu().tolist(), cpu.iters.tolist()
        rel = float(((og - oc).abs() / oc.abs()).max())
        rows.append(dict(case=label, objective_card=og.tolist(),
                         objective_cpu=oc.tolist(), max_rel_diff=rel,
                         iters_card=ig, iters_cpu=ic, card_s=card_s,
                         cpu_s=cpu_s))
        check(rel <= 1e-8, f"paper paths, {label}: card vs CPU objective "
                           f"rel diff {rel:.3g} > 1e-8")
        check(ig == ic, f"paper paths, {label}: BCD iterations differ "
                        f"({ig} vs {ic})")

    fig8 = make_system(FIG8_SEED, n_devices=FIG8_N, device="cuda",
                       dtype=torch.float64, p_max=dbm_to_watt(FIG8_PMAX_DBM))
    for T_total in FIG8_DEADLINES:
        compare(f"fig8.T{T_total:g}", Problem(
            system=fig8, weights=Weights(*FIG8_WEIGHTS), deadline=T_total),
            SolverSpec(max_iters=FIG8_ITERS))
    cell = make_system(PAPER_SEED, n_devices=PAPER_N, device="cuda",
                       dtype=torch.float64)
    weights = Weights(*WEIGHTS)
    compare("paper.bisect", Problem(system=cell, weights=weights),
            SolverSpec(sp1_method="bisect"))
    compare("paper.jong", Problem(system=cell, weights=weights),
            SolverSpec(**JONG_SPEC))
    compare("paper.log", Problem(system=cell, weights=weights,
                                 acc=log_fit()), SolverSpec())
    four = fleet_system(torch, torch.float64, 4)
    spec = SolverSpec(max_iters=FLEET_ITERS)
    free = solve(Problem(system=four, weights=weights), spec)
    problem, _ = deadline_problem(torch, four, free)
    compare("fleet4.deadline", problem, spec)
    record("paper_paths", dtype="float64", cases=rows,
           jong_cut=JONG_SPEC)


def saved_counts(wrapper):
    """The launch counts a kernel wrapper keeps (`launches` and any
    per-body or per-pass `launches_by_*`), to put back after launches that
    only time it."""
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in vars(wrapper).items() if k.startswith("launches")}


def restore_counts(wrapper, saved):
    for k, v in saved.items():
        setattr(wrapper, k, v)


def event_ms(torch, fn, reps):
    """Mean milliseconds per call of `fn` over `reps` calls (CUDA events),
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps, key):
    """Device milliseconds per call of `fn`, from `reps` calls under
    torch.profiler after a warm-up call: for every kernel whose name
    matches the pattern `key` (each launched once per call), its self
    device time over the launches the profile caught, summed over those
    kernels. The profile can miss the first few launches it traces, so
    each kernel is averaged over its own count; a profile that caught none
    is taken again with twice the calls, up to three times. Event timing
    of back-to-back calls measures the host once a kernel is faster than
    its wrapper; this reads the card alone. Returns (ms, {kernel:
    {"launches": caught, "ms": its device ms per launch}})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps << attempt):
                fn()
            torch.cuda.synchronize()
        hits = {e.key[:80]: dict(launches=e.count,
                                 ms=e.self_device_time_total / 1e3 / e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and re.search(key, e.key) and e.count}
        if hits:
            break
    check(hits, f"device_ms: the profile shows no kernel matching {key!r}")
    return sum(h["ms"] for h in hits.values()), hits


def kernel_time(torch, kernel, plain, args, reps, plain_reps, ops, dtype,
                key):
    """ms per launch of `kernel` (CUDA events), its device ms (`device_ms`
    over the kernels matching `key`; neither run counts on the main path),
    ms of its plain version, and its bound: the larger of the bytes it must
    move (each input read once, the output written once) at HBM peak and
    its counted operations at `dtype`'s peak."""
    saved = saved_counts(kernel)
    ms = event_ms(torch, lambda: kernel(*args), reps)
    dev_ms, dev_kernels = device_ms(torch, lambda: kernel(*args), reps, key)
    restore_counts(kernel, saved)
    plain_ms = event_ms(torch, lambda: plain(*args), plain_reps)
    out = plain(*args)
    moved = sum(a.numel() * a.element_size() for a in args) \
        + out.numel() * out.element_size()
    bytes_ms = moved / PEAK_BYTES_S * 1e3
    ops_ms = ops / PEAK_OPS_S[dtype] * 1e3
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                library_ms=None), dict(bytes=moved, ops=ops,
                                       bytes_bound_ms=bytes_ms,
                                       ops_bound_ms=ops_ms,
                                       device_kernels=dev_kernels)


def sass_loop(library, entry):
    """The SASS of the kernel entry of `library` whose mangled name holds
    `entry`, as cuobjdump prints it: the instructions (NOPs left out) of
    its innermost loop that holds a special-function (MUFU) instruction,
    with the MUFUs among them, and of the whole entry. In sp1_sweep.cu
    that loop is the candidate loop, one (m, n) pair a trip: the pair's
    lambda_n(T_m) and its step of the sum. Static counts: a branch that
    skips work (or the tree sum nested in the loop) counts once."""
    from repro_torch.kernels import build

    tool = Path(build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(library)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    funcs = [f for f in re.split(r"\n\s*Function : ", text)[1:]
             if entry in f.split("\n", 1)[0]]
    check(len(funcs) == 1, f"sass_loop: {len(funcs)} entries match {entry}")
    labels, insts, pending = {}, [], []
    for line in funcs[0].splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            labels.update((p, addr) for p in pending)
            pending = []
            insts.append((addr, m.group(2)))
    loops = []
    for addr, ins in insts:
        if not re.search(r"\bBRA\b", ins):
            continue
        t = re.search(r"(0x[0-9a-f]+|\.L_x_\d+)\)?\s*$", ins)
        target = None if t is None else (
            int(t.group(1), 16) if t.group(1).startswith("0x")
            else labels.get(t.group(1)))
        if target is not None and target < addr:
            loops.append((target, addr))
    mufu = [a for a, ins in insts if re.search(r"\bMUFU\b", ins)]
    inner = [lp for lp in loops if any(lp[0] <= a <= lp[1] for a in mufu)]
    check(inner, f"sass_loop: no loop of {entry} holds a MUFU")
    lo, hi = min(inner, key=lambda lp: lp[1] - lp[0])
    body = [ins for a, ins in insts if lo <= a <= hi
            and not re.match(r"(@\S+\s+)?NOP\b", ins)]
    return dict(loop_instructions=len(body),
                loop_mufu=sum(bool(re.search(r"\bMUFU\b", i)) for i in body),
                entry_instructions=len(insts))


def sp1_ops(torch, T_grid, q, tt, consts):
    """The operations sp1_lambda_sum needs on these inputs (the count of
    SP1_OPS_PER_PAIR and its neighbours), and the pairs whose deadline is
    unattainable, found by lambda_of_T_linear's own test."""
    C, M = T_grid.shape
    N = q.shape[1]
    t_c = torch.clamp_min(T_grid[:, :, None] - tt[:, None, :],
                          torch.finfo(q.dtype).tiny)
    s_lo, f_max = consts[:, 4, None, None], consts[:, 3, None, None]
    floor = q[:, None, :] * (s_lo * s_lo) / torch.clamp_min(f_max, 1e-9)
    saturated = int((floor > t_c).sum())
    ops = SP1_OPS_PER_PAIR * (C * M * N - saturated) \
        + SP1_OPS_PER_SATURATED_PAIR * saturated \
        + SP1_OPS_PER_DEVICE * C * N + SP1_OPS_PER_CELL * C
    return ops, saturated


def sp1_time(torch):
    """sp1_lambda_sum at the fleet shape (C=64, M=16, N=2048): float32 by
    events and device time beside its bound and plain version, float64 the
    same, and the SASS of the candidate loop (`sass_loop`) and ptxas's
    registers and spills of every entry. library_ms: no single PyTorch
    call computes the function."""
    from repro_torch.kernels import build, sp1_sweep

    row = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        args, _, _ = sweep_inputs(torch, fleet_system(torch, dtype))
        C, M = args[0].shape
        N = args[1].shape[1]
        ops, saturated = sp1_ops(torch, *args)
        times, extra = kernel_time(torch, sp1_sweep.sp1_lambda_sum,
                                   sp1_sweep.sp1_lambda_sum_ref, args, 200,
                                   10, ops, name,
                                   DEVICE_KEYS["sp1_lambda_sum"])
        sass = sass_loop(build.library_path("sp1_sweep"),
                         {"float32": "sp1_partial_kernelIf",
                          "float64": "sp1_partial_kernelId"}[name])
        record("kernel_times", kernel="sp1_lambda_sum", C=C, M=M, N=N,
               dtype=name, **times, **extra, saturated_pairs=saturated,
               sass=sass)
        if dtype == torch.float32:
            row.update(times, sass_per_pair=sass["loop_instructions"])
        else:
            row.update(float64_ms=times["ms"],
                       float64_device_ms=times["device_ms"],
                       float64_bound_ms=times["bound_ms"],
                       float64_sass_per_pair=sass["loop_instructions"])
    row["ptxas"] = ptxas_entries(build.log_path("sp1_sweep").read_text())
    return row


def waterfill_time(torch):
    """waterfill_gprime on the Theorem-2 region's first sweep (C=1, M=128,
    N=2^17, float32), with the Halley steps of its exit rule. library_ms:
    no PyTorch call computes Lambert W."""
    from repro_torch.kernels import waterfill

    region = region_system(torch, torch.float32)
    rmin, nu, _ = thm2_instance(torch, region)
    args = thm2_sweep_inputs(torch, region, nu, rmin)
    C, M = args[0].shape
    N = args[1].shape[1]
    times, extra = kernel_time(torch, waterfill.waterfill_gprime,
                               waterfill.waterfill_gprime_ref, args, 50, 3,
                               WATERFILL_OPS_PER_PAIR * C * M * N, "float32",
                               DEVICE_KEYS["waterfill_gprime"])
    record("kernel_times", kernel="waterfill_gprime", C=C, M=M, N=N,
           dtype="float32", **times, **extra, **halley_steps(torch, args))
    return times


def phase_times(torch, kernels):
    from repro_torch import Problem, SolverSpec, Weights

    fleet = fleet_system(torch, torch.float32)
    problem = Problem(system=fleet, weights=Weights(*WEIGHTS))
    spec = SolverSpec(max_iters=FLEET_ITERS)
    walls = []
    for _ in range(3):
        _, counts, reads, wall = counted_solve(torch, problem, spec)
        walls.append(wall)
    record("fleet_solve", C=FLEET_C, N=FLEET_N, dtype="float32",
           max_iters=FLEET_ITERS, walls_s=walls,
           median_s=statistics.median(walls), host_reads=reads,
           launches=counts)
    for k in kernels:
        k.update(KERNELS[k["name"]][3](torch))


def halley_steps(torch, args):
    """The Halley steps of `waterfill_gprime`'s (m, n) pairs on `args` under
    the kernel's exit rule, replayed in plain PyTorch on the card
    (`waterfill.lambertw_early_exit`; the kernel counts nothing): the mean
    over lanes, the mean over warps (32 adjacent devices of one candidate,
    as the kernel lays them out: a warp runs as many steps as its slowest
    lane; lanes past N take none), the largest, and the operations bound of
    the early-exit form at these steps. The kernel's products are never fused
    into multiply-adds, so it rounds as the plain version does, and these
    are the kernel's steps where its exp and log round as PyTorch's do."""
    from repro_torch.kernels import waterfill

    mu, j, _, _ = args
    q = mu[:, :, None] / j[:, None, :]
    _, steps = waterfill.lambertw_early_exit(q)
    pad = -j.shape[1] % 32
    warp_steps = torch.nn.functional.pad(steps, (0, pad)).reshape(
        *steps.shape[:2], -1, 32).amax(-1)
    ops = WATERFILL_OPS_OUTSIDE_HALLEY * steps.numel() \
        + WATERFILL_OPS_PER_EXIT_STEP * float(steps.double().sum())
    return dict(halley_steps_lane_mean=float(steps.double().mean()),
                halley_steps_warp_mean=float(warp_steps.double().mean()),
                halley_steps_max=int(steps.max()),
                halley_steps_at_cap_share=float(
                    (steps == waterfill.HALLEY_STEPS).double().mean()),
                bound_fixed_point_ms=ops / PEAK_OPS_S["float32"] * 1e3,
                bound_fixed_point_ops=ops)


def lm_kernel_time(torch, name, counter, fn, plain, library, moved, ops,
                   dtype, reps, plain_reps, **extra):
    """ms per launch of `fn` (CUDA events) and its device ms (`device_ms`;
    the timing launches are taken off `counter.launches`), ms of its plain
    version and of the library call, and the bound: the larger of `moved`
    bytes at HBM peak and `ops` at `dtype`'s peak. `extra` goes into the
    record only."""
    saved = saved_counts(counter)
    ms = event_ms(torch, fn, reps)
    dev_ms, dev_kernels = device_ms(torch, fn, reps, DEVICE_KEYS[name])
    restore_counts(counter, saved)
    plain_ms = event_ms(torch, plain, plain_reps)
    library_ms = event_ms(torch, library, reps) if library else None
    bytes_ms = moved / PEAK_BYTES_S * 1e3
    ops_ms = ops / PEAK_OPS_S[dtype] * 1e3
    times = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                 bound_ms=max(bytes_ms, ops_ms),
                 bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                 library_ms=library_ms)
    record("kernel_times", kernel=name, dtype=dtype, **times, bytes=moved,
           ops=ops, bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
           device_kernels=dev_kernels, **extra)
    return times


def flash_time(torch):
    """flash_attention at each served prefill shape (bf16, causal):
    internlm2-20b's (4,48,8,2048,128), whose numbers go into the `kernels`
    line (48 of its 49 launches), and jamba's (4,64,8,2048,128), each in
    its own record. Operations: the causal (s, t) pairs this mask keeps,
    S (S + 1) / 2 per (b, h), each a hd-long dot and a vd-long update (2
    flops per MAC; the exponentials are left out), at the bf16 tensor-core
    rate. library_ms is one scaled_dot_product_attention call on the same
    tensors, timed here only: the port never calls it."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels import flash_attention as fa

    times = {}
    for arch, (B, H, KV, S, T, hd, vd, _, _) in flash_main_cases().items():
        q, k, v = flash_inputs(torch, B, H, KV, S, T, hd, vd, torch.bfloat16)
        moved = sum(x.numel() * x.element_size() for x in (q, k, v)) \
            + B * H * S * vd * q.element_size()
        ops = B * H * (S * (S + 1) // 2) * 2 * (hd + vd)
        times[arch] = lm_kernel_time(
            torch, "flash_attention", fa.flash_attention,
            lambda: fa.flash_attention(q, k, v, causal=True),
            lambda: fa.flash_attention_ref(q, k, v, causal=True),
            lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
            moved, ops, "bfloat16", 20, 3, arch=arch, body=fa.body(q, k, v),
            shape=[B, H, KV, S, T, hd, vd])
        del q, k, v
    return times[LM_DENSE]


def rwkv_time(torch):
    """rwkv6_scan at the rwkv6-1.6b prefill shape (float32, chunk 64).
    Operations: those of the recurrence the function defines, per (b, t, h):
    r S (2 K^2), S <- w S + k v^T (3 K^2), w = exp(log w) (K) and the u bonus
    (r u k summed, times v, added: 5 K), float32 outside the tensor cores;
    the chunked form the kernel runs does more. Bytes: r, k, v, log w and u
    read once, the output and the final state written once. No PyTorch call
    computes it. ms is one call (both passes); each pass is also timed
    alone (the output pass on the states of an earlier call)."""
    from repro_torch.kernels import rwkv6_scan as rw

    B, T, H, K, L, _ = rwkv_cases()[-1]
    xs = rwkv_inputs(torch, B, T, H, K)
    ops = B * T * H * (5 * K * K + 6 * K)
    moved = sum(x.numel() * x.element_size() for x in xs) \
        + 4 * (B * T * H * K + B * H * K * K)
    bufs = rw.buffers(xs[0], L)
    saved = saved_counts(rw.rwkv6_scan)
    rw.launch(*xs, *bufs, chunk=L)   # the states the output pass reads
    pass_ms = {p: event_ms(torch, lambda p=p: rw.launch(
                   *xs, *bufs, chunk=L, passes=(p,)), 20)
               for p in rw.PASSES}
    restore_counts(rw.rwkv6_scan, saved)
    del bufs
    return lm_kernel_time(
        torch, "rwkv6_scan", rw.rwkv6_scan,
        lambda: rw.rwkv6_scan(*xs, chunk=L),
        lambda: rw.rwkv6_scan_ref(*xs, chunk=L), None,
        moved, ops, "float32", 20, 3, shape=[B, T, H, K], chunk=L,
        state_pass_ms=pass_ms["state"], output_pass_ms=pass_ms["output"])


def mamba_time(torch):
    """mamba_scan at the jamba-1.5-large prefill shape (float32). Bytes: dt
    and x read and y written (B T D each), Bt and Ct (B T N each) and A
    (D N) read, the final state (B D N) written, once each. Operations, per
    (b, t, d, n): the decay's product and exponential (2), the update
    a h + (dt B) x (4) and the y term h C and its sum over n (2), float32
    outside the tensor cores, an exponential counted as one operation. The
    exponentials alone take B T D N / SFU_EXP_S on the special-function
    units: recorded beside the bound, not in it. No PyTorch call computes
    the selective scan."""
    from repro_torch.kernels import mamba_scan as ms

    B, T, D, N, dt_max = mamba_cases()[-1]
    xs = mamba_inputs(torch, B, T, D, N, dt_max)
    ops = 8 * B * T * D * N
    moved = 4 * (3 * B * T * D + 2 * B * T * N + D * N + B * D * N)
    return lm_kernel_time(
        torch, "mamba_scan", ms.mamba_scan, lambda: ms.mamba_scan(*xs),
        lambda: ms.mamba_scan_ref(*xs), None, moved, ops, "float32", 20, 2,
        shape=[B, T, D, N], exp_sfu_ms=B * T * D * N / SFU_EXP_S * 1e3)


def trace(torch, label, problem, spec):
    """One solve under torch.profiler (`trace_call`), with its launch and
    host-read counts. Tracing slows the host, so the traced wall time is
    longer than the untraced one."""
    (_, counts, reads, _), rec = trace_call(
        torch, lambda: counted_solve(torch, problem, spec))
    record("profile", topology=label, C=FLEET_C, N=FLEET_N, dtype="float32",
           host_reads=reads, launches=counts, **rec)


def phase_profile(torch):
    """The fleet solve, the deadline-fleet solve, the padded pool's solve,
    one warm round of the rounds fleet (the round after a first, untraced
    one, warm-started from its allocation), one `solve_and_grad` on the
    fleet, one warm Theorem-2 call on the region and one served batch of
    the region serving stack, traced."""
    from repro_torch import Problem, RoundsConfig, SolverSpec, Weights, solve
    from repro_torch.core.sp2 import solve_sp2_v2_thm2
    from repro_torch.diff import solve_and_grad

    fleet = fleet_system(torch, torch.float32)
    spec = SolverSpec(max_iters=FLEET_ITERS)
    problem = Problem(system=fleet, weights=Weights(*WEIGHTS))
    trace(torch, "fleet", problem, spec)
    deadline, _ = deadline_problem(torch, fleet, solve(problem, spec))
    trace(torch, "deadline_fleet", deadline, spec)
    pool, _, _ = padded_pool(torch, torch.float32)
    trace(torch, "padded_fleet", Problem(system=pool,
                                         weights=Weights(*WEIGHTS)), spec)
    one_round = RoundsConfig(**dict(ROUNDS, rounds=1))
    first = solve(Problem(system=fleet, weights=Weights(*WEIGHTS),
                          rounds=one_round, key=ROUNDS_SEED))
    trace(torch, "rounds_fleet_warm_round", Problem(
        system=fleet, weights=Weights(*WEIGHTS), rounds=one_round,
        key=ROUNDS_SEED + 1, init=first.allocation), None)
    (_, counts, reads, _), rec = trace_call(torch, lambda: counted(
        torch, lambda: solve_and_grad(problem, spec, adjoint_iters=30)))
    record("profile", topology="grad", C=FLEET_C, N=FLEET_N, dtype="float32",
           host_reads=reads, launches=counts, **rec)

    region = region_system(torch, torch.float32)
    rmin, nu, beta = thm2_instance(torch, region)
    w = Weights(*WEIGHTS)
    solve_sp2_v2_thm2(region, w, nu, beta, rmin)
    (_, counts, reads, _), rec = trace_call(torch, lambda: counted(
        torch, lambda: solve_sp2_v2_thm2(region, w, nu, beta, rmin)))
    record("profile", topology="region_thm2", N=REGION_N, dtype="float32",
           host_reads=reads, launches=counts, **rec)
    check(counts["waterfill_gprime"] == 4,
          f"region: {counts['waterfill_gprime']} waterfill_gprime launches "
          "in the traced Theorem-2 call, want 4")
    trace_served_batch(torch)


# ---------------------------------------------------------------------------
# the LM serving path: flash_attention and rwkv6_scan
# ---------------------------------------------------------------------------

def flash_main_cases():
    """The attention prefill of every served configuration that has
    attention layers, at full width: {arch: (B, H, KV, S, T, hd, vd,
    causal, window)}, from the configs themselves."""
    from repro_torch.configs import get_config

    cases = {}
    for arch in (LM_DENSE, LM_HYBRID):
        cfg = get_config(arch)
        vd = cfg.v_head_dim or cfg.head_dim
        cases[arch] = (LM_BATCH, cfg.n_heads, cfg.kv_heads, LM_PROMPT,
                       LM_PROMPT, cfg.head_dim, vd, True, cfg.sliding_window)
    return cases


def flash_cases():
    """(B, H, KV, S, T, hd, vd, causal, window): tests/test_kernels.py's
    shapes (MHA, GQA 2:1, MQA, window 128, non-causal T != S), ragged ones,
    and the served prefills of flash_main_cases() (last, on the main
    paths)."""
    return [(1, 2, 2, 128, 128, 64, 64, True, None),
            (2, 4, 2, 256, 256, 64, 64, True, None),
            (1, 8, 1, 128, 128, 128, 128, True, None),
            (2, 4, 2, 256, 256, 64, 64, True, 128),
            (1, 2, 2, 128, 256, 64, 64, False, None),
            (2, 4, 2, 77, 77, 32, 32, True, None),
            (1, 3, 1, 70, 130, 96, 64, False, None),
            *flash_main_cases().values()]


def flash_inputs(torch, B, H, KV, S, T, hd, vd, dtype, seed=0):
    # unit-variance q and k: the scores spread by about 1, so the softmax is
    # far from uniform and |o| is not held small by averaging
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, H, S, hd), generator=gen, device="cuda")
    k = torch.randn((B, KV, T, hd), generator=gen, device="cuda")
    v = torch.randn((B, KV, T, vd), generator=gen, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def flash_spread(torch, q, k, v, causal, window):
    """r = sqrt(sum_t p_st^2 v_t^2) for every output element, from the plain
    version's softmax P (default scale), one batch row at a time."""
    G, S, T = q.shape[1] // k.shape[1], q.shape[2], k.shape[2]
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    hidden = (kpos > qpos) if causal else torch.zeros_like(kpos > qpos)
    if window is not None:
        hidden = hidden | (kpos <= qpos - window)
    rows = []
    for b in range(q.shape[0]):
        kb = k[b].float().repeat_interleave(G, 0)
        vb = v[b].float().repeat_interleave(G, 0)
        sc = q[b].float() @ kb.transpose(-1, -2) * q.shape[-1] ** -0.5
        p = torch.softmax(sc.masked_fill(hidden, -1e30), -1)
        rows.append(((p * p) @ (vb * vb)).sqrt())
        del kb, vb, sc, p
    return torch.stack(rows)


def phase_flash_kernel(torch):
    """flash_attention against its plain version on the card, each case on
    the body `flash_attention.body` picks (counted per body); the served
    prefills must take the wgmma body, also as the model's (B, S, H, hd)
    transposed views, which must give the same bits."""
    from repro_torch.kernels import flash_attention as fa

    rows, main_err = [], 0.0
    cases, main = flash_cases(), set(flash_main_cases().values())
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        tol, atol = FLASH_TOL[name], FLASH_ATOL[name]
        u = FLASH_P_ROUNDOFF[name]
        for i, (B, H, KV, S, T, hd, vd, causal, window) in enumerate(cases):
            q, k, v = flash_inputs(torch, B, H, KV, S, T, hd, vd, dtype)
            kw = dict(causal=causal, window=window)
            which = fa.body(q, k, v)
            before = dict(fa.flash_attention.launches_by_body)
            out = fa.flash_attention(q, k, v, **kw)
            again = fa.flash_attention(q, k, v, **kw)
            plain = fa.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            ran = {b: n - before[b]
                   for b, n in fa.flash_attention.launches_by_body.items()}
            mag = plain.float().abs()
            err = (out.float() - plain.float()).abs()
            spread = flash_spread(torch, q, k, v, causal, window) if u \
                else torch.zeros_like(mag)
            allowed = tol * mag + 4 * u * spread + atol
            excess = float((err - allowed).max())
            where = f"{(B, H, KV, S, T, hd, vd)}, causal={causal}, " \
                    f"window={window}, {name}"
            rows.append(dict(shape=[B, H, KV, S, T, hd, vd], causal=causal,
                             window=window, dtype=name, body=which,
                             max_abs_err=float(err.max()), tol=tol,
                             atol=atol, p_roundoff=u,
                             median_abs_plain=float(mag.median()),
                             median_allowed=float(allowed.median()),
                             max_err_over_allowed=float((err / allowed).max()),
                             finite=bool(torch.isfinite(out).all()),
                             repeatable=torch.equal(out, again)))
            served = cases[i] in main and dtype == torch.bfloat16
            if served:
                main_err = max(main_err, float(err.max()))
                # the model's layout: (B, S, heads, hd) transposed
                qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2)
                              for x in (q, k, v))
                view_body = fa.body(qt, kt, vt)
                rows[-1].update(model_layout_body=view_body,
                                model_layout_same=torch.equal(
                                    fa.flash_attention(qt, kt, vt, **kw),
                                    out))
                del qt, kt, vt
                check(which == view_body == "wgmma",
                      f"flash_attention: served shape on the {which} body "
                      f"(model layout {view_body}), not wgmma ({where})")
                check(rows[-1]["model_layout_same"],
                      f"flash_attention: model layout differs ({where})")
            check(ran == {b: 2 * (b == which) for b in ran},
                  f"flash_attention: launches by body {ran}, want 2 on "
                  f"{which} ({where})")
            check(rows[-1]["finite"], f"flash_attention: non-finite ({where})")
            check(rows[-1]["repeatable"],
                  f"flash_attention: two launches differ ({where})")
            check(excess <= 0, f"flash_attention: |kernel - plain| exceeds "
                               f"{tol:g} |plain| + 4 ({u:g}) r + {atol:g} "
                               f"({where})")
            del q, k, v, out, again, plain, err, mag, spread, allowed
    torch.cuda.empty_cache()
    record("kernel_vs_plain", kernel="flash_attention",
           tolerance="|kernel - plain| <= tol |plain| + 4 u r + atol, "
                     "r = sqrt(sum_t p_t^2 v_t^2)", cases=rows)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:67",
                launches=None, max_abs_err=main_err)


def rwkv_inputs(torch, B, T, H, K, strong=False, seed=2):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = torch.randn((B, T, H, K), generator=gen, device="cuda") * 0.5
    k = torch.randn((B, T, H, K), generator=gen, device="cuda") * 0.5
    v = torch.randn((B, T, H, K), generator=gen, device="cuda")
    logw = torch.full((B, T, H, K), -8.0, device="cuda") if strong else \
        -torch.exp(torch.randn((B, T, H, K), generator=gen, device="cuda")
                   * 0.5 - 0.5)
    u = torch.randn((H, K), generator=gen, device="cuda") * 0.3
    return r, k, v, logw, u


def rwkv_cases():
    """(B, T, H, K, chunk, strong): tests/test_kernels.py's shapes, the
    log w = -8 strong decay, ragged T, K 16 and 64 at chunks 32 and 16, and
    the rwkv6-1.6b prefill (last)."""
    return [(1, 64, 2, 32, 32, False), (2, 128, 4, 64, 64, False),
            (1, 128, 2, 32, 64, True), (2, 100, 3, 32, 16, False),
            (1, 90, 3, 16, 32, False), (2, 50, 2, 64, 16, True),
            (LM_BATCH, LM_PROMPT, 32, 64, 64, False)]


def phase_rwkv_kernel(torch):
    """rwkv6_scan against its plain version on the card: output and final
    state."""
    from repro_torch.kernels import rwkv6_scan as rw

    rows, main_err = [], 0.0
    cases = rwkv_cases()
    for i, (B, T, H, K, chunk, strong) in enumerate(cases):
        xs = rwkv_inputs(torch, B, T, H, K, strong)
        o, S = rw.rwkv6_scan(*xs, chunk=chunk)
        o2, S2 = rw.rwkv6_scan(*xs, chunk=chunk)
        po, pS = rw.rwkv6_scan_ref(*xs, chunk=chunk)
        torch.cuda.synchronize()
        eo, eS = (o - po).abs(), (S - pS).abs()
        excess = max(float((eo - RWKV_TOL * po.abs()).max()),
                     float((eS - RWKV_TOL * pS.abs()).max()))
        where = f"{(B, T, H, K)}, chunk={chunk}, strong={strong}"
        rows.append(dict(shape=[B, T, H, K], chunk=chunk, strong_decay=strong,
                         dtype="float32", max_abs_err_out=float(eo.max()),
                         max_abs_err_state=float(eS.max()), tol=RWKV_TOL,
                         finite=bool(torch.isfinite(o).all()
                                     and torch.isfinite(S).all()),
                         repeatable=torch.equal(o, o2) and torch.equal(S, S2)))
        if i == len(cases) - 1:
            main_err = max(float(eo.max()), float(eS.max()))
        check(rows[-1]["finite"], f"rwkv6_scan: non-finite ({where})")
        check(rows[-1]["repeatable"],
              f"rwkv6_scan: two launches differ ({where})")
        check(excess <= RWKV_TOL, f"rwkv6_scan: |kernel - plain| exceeds "
                                  f"{RWKV_TOL:g} (1 + |plain|) ({where})")
    record("kernel_vs_plain", kernel="rwkv6_scan",
           tolerance="|kernel - plain| <= tol (1 + |plain|), output and "
                     "final state", cases=rows)
    return dict(name="rwkv6_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                replaces="src/repro/kernels/rwkv6_scan.py:63",
                launches=None, max_abs_err=main_err)


def mamba_inputs(torch, B, T, D, N, dt_max=None, seed=4):
    """dt = softplus(z - 1) (or uniform in [0.01, dt_max]), A = -(1..N) in
    every channel (the model's -exp(a_log)), and Bt, Ct as the two halves
    of one (B, T, 2N) tensor: the strided views the model passes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, T, D)
    dt = torch.nn.functional.softplus(
        torch.randn(shape, generator=gen, device="cuda") - 1) \
        if dt_max is None else 0.01 + (dt_max - 0.01) * torch.rand(
            shape, generator=gen, device="cuda")
    A = -torch.arange(1, N + 1, dtype=torch.float32,
                      device="cuda").expand(D, N).contiguous()
    bc = torch.randn((B, T, 2 * N), generator=gen, device="cuda") * 0.5
    x = torch.randn(shape, generator=gen, device="cuda")
    Bt, Ct = bc.chunk(2, -1)
    return dt, A, Bt, Ct, x


def mamba_cases():
    """(B, T, D, N, dt_max): tests/test_kernels.py's shapes, ragged T and D
    (no multiple of the 16-step tile or the 128-channel block), one step,
    the strong decay (dt up to 5, dt A down to -80), and the
    jamba-1.5-large prefill (last)."""
    from repro_torch.configs import get_config

    cfg = get_config(LM_HYBRID)
    return [(1, 64, 128, 8, None), (2, 128, 256, 16, None),
            (2, 100, 50, 16, None), (1, 37, 33, 8, None),
            (1, 1, 16, 16, None), (1, 200, 64, 16, 5.0),
            (2, 333, 1000, 16, 5.0),
            (LM_BATCH, LM_PROMPT, cfg.d_inner, cfg.d_state, None)]


def phase_mamba_kernel(torch):
    """mamba_scan against its plain version on the card: y and the final
    state, on strided Bt / Ct views (and bitwise the same on contiguous
    copies)."""
    from repro_torch.kernels import mamba_scan as ms

    rows, main_err = [], 0.0
    cases = mamba_cases()
    for i, (B, T, D, N, dt_max) in enumerate(cases):
        dt, A, Bt, Ct, x = mamba_inputs(torch, B, T, D, N, dt_max)
        y, h = ms.mamba_scan(dt, A, Bt, Ct, x)
        y2, h2 = ms.mamba_scan(dt, A, Bt, Ct, x)
        y3, h3 = ms.mamba_scan(dt, A, Bt.contiguous(), Ct.contiguous(), x)
        py, ph = ms.mamba_scan_ref(dt, A, Bt, Ct, x)
        torch.cuda.synchronize()
        ey, eh = (y - py).abs(), (h - ph).abs()
        excess = max(float((ey - MAMBA_TOL * py.abs()).max()),
                     float((eh - MAMBA_TOL * ph.abs()).max()))
        where = f"{(B, T, D, N)}, dt_max={dt_max}"
        rows.append(dict(shape=[B, T, D, N], dt_max=dt_max, dtype="float32",
                         min_dt_A=float((dt.amax() * A.amin())),
                         max_abs_err_y=float(ey.max()),
                         max_abs_err_state=float(eh.max()),
                         max_abs_plain_y=float(py.abs().max()),
                         tol=MAMBA_TOL,
                         finite=bool(torch.isfinite(y).all()
                                     and torch.isfinite(h).all()),
                         repeatable=torch.equal(y, y2) and torch.equal(h, h2),
                         strided_same=torch.equal(y, y3)
                         and torch.equal(h, h3)))
        if i == len(cases) - 1:
            main_err = max(float(ey.max()), float(eh.max()))
        check(rows[-1]["finite"], f"mamba_scan: non-finite ({where})")
        check(rows[-1]["repeatable"],
              f"mamba_scan: two launches differ ({where})")
        check(rows[-1]["strided_same"],
              f"mamba_scan: strided and contiguous Bt / Ct differ ({where})")
        check(excess <= MAMBA_TOL, f"mamba_scan: |kernel - plain| exceeds "
                                   f"{MAMBA_TOL:g} (1 + |plain|) ({where})")
        del dt, A, Bt, Ct, x, y, h, y2, h2, y3, h3, py, ph, ey, eh
    torch.cuda.empty_cache()
    record("kernel_vs_plain", kernel="mamba_scan",
           tolerance="|kernel - plain| <= tol (1 + |plain|), y and final "
                     "state", cases=rows)
    return dict(name="mamba_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/mamba_scan.cu",
                replaces="src/repro/kernels/mamba_scan.py:51",
                launches=None, max_abs_err=main_err)


def lm_config(arch):
    """The served configuration: jamba cut to its first LM_HYBRID_LAYERS
    layers at full width, the others whole."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == LM_HYBRID:
        cfg = cfg.replace(n_layers=LM_HYBRID_LAYERS,
                          block_pattern=cfg.block_pattern[:LM_HYBRID_LAYERS])
    return cfg


def prefill_launches(cfg):
    """The kernel launches of one prefill of `cfg`: one flash_attention,
    mamba_scan or rwkv6_scan per attention, Mamba or RWKV layer; none of
    the solver kernels."""
    kinds = {"flash_attention": ("attn", "attn_moe"),
             "mamba_scan": ("mamba", "mamba_moe"), "rwkv6_scan": ("rwkv",)}
    want = {k: cfg.n_periods * sum(kind in ks for kind in cfg.block_pattern)
            for k, ks in kinds.items()}
    return dict(want, sp1_lambda_sum=0, waterfill_gprime=0)


def serve_argv():
    """serve.main's flags for the served traffic; the config goes in as
    `cfg=`."""
    return ["--batch", str(LM_BATCH), "--prompt-len", str(LM_PROMPT),
            "--gen", str(LM_GEN), "--seed", str(LM_SEED), "--device", "cuda"]


# each kernel's device entries in a profile, by the name of its wrapper,
# and all the port's own kernels (csrc/*.cu: anonymous namespaces)
DEVICE_KEYS = {"sp1_lambda_sum": r"::sp1_",
               "waterfill_gprime": r"::waterfill_",
               "flash_attention": r"::flash_",
               "rwkv6_scan": r"::rwkv6_",
               "mamba_scan": r"::mamba_scan"}
PORT_KERNEL_KEY = re.compile(
    r"\(anonymous namespace\)(" + "|".join(DEVICE_KEYS.values()) + ")")


def trace_call(torch, fn, within=None):
    """fn() under torch.profiler: its wall time, the card's busy time and
    idle share, the kernels that take the most time, and each of the
    port's own kernels that ran. With `within` (the name of a
    record_function range, such as an obs span's), each port kernel's
    launches that ran inside and outside that range (`within` in the
    record). Returns (fn's result, record).

    The device events are read off the profiler's raw kineto events:
    building `key_averages()` costs ~60 us an event on the host, minutes
    for the ~10^5-10^6 launches of a gradient or rounds run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}                          # name -> [calls, device ns]
    events = prof.profiler.kineto_results.events()
    # a record_function range (an obs span) also shows on the card's
    # timeline as a user annotation: it is not a kernel
    for e in events:
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            k = kernels.setdefault(e.name(), [0, 0])
            k[0] += 1
            k[1] += e.duration_ns()
    extra = {}
    if within is not None:
        spans = [(e.start_ns(), e.end_ns()) for e in events
                 if e.device_type() == DeviceType.CPU
                 and e.name() == within]
        extra["within"] = {name: dict(inside=0, outside=0)
                           for name in DEVICE_KEYS}
        for e in events:
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            for name, key in DEVICE_KEYS.items():
                if re.search(key, e.name()):
                    inside = any(lo <= e.start_ns() and e.end_ns() <= hi
                                 for lo, hi in spans)
                    extra["within"][name]["inside" if inside
                                          else "outside"] += 1
        extra["within_ranges"] = len(spans)
    busy_ms = sum(k[1] for k in kernels.values()) / 1e6
    rows = [dict(name=name[:80], calls=k[0], device_ms=k[1] / 1e6)
            for name, k in kernels.items()]
    return out, dict(
        traced_wall_s=wall, device_busy_ms=busy_ms,
        device_idle_share=(1.0 - busy_ms / (wall * 1e3)) if busy_ms else None,
        kernel_launches=sum(k[0] for k in kernels.values()),
        top_kernels=sorted(rows, key=lambda r: -r["device_ms"])[:8],
        port_kernels=[r for name, r in zip(kernels, rows)
                      if PORT_KERNEL_KEY.search(name)], **extra)


def phase_lm_serve(torch):
    """`repro_torch.launch.serve.main` for the three configurations (jamba
    cut to LM_HYBRID_LAYERS, the others whole), twice each (the same
    tokens), then the decode cache's hand-over: a prefill over prompt +
    first generated token against the first decode step, with that prefill
    traced."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.launch import serve
    from repro_torch.models.transformer import (init_cache, init_model,
                                                prefill, serve_step)

    runs = {}
    for arch in (LM_DENSE, LM_RWKV, LM_HYBRID):
        cfg = lm_config(arch)
        want = prefill_launches(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        gen, counts, _, wall = counted(
            torch, lambda: serve.main(serve_argv(), stats=stats, cfg=cfg))
        bodies = dict(fa.flash_attention.launches_by_body)
        passes = dict(rw.rwkv6_scan.launches_by_pass)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        last = stats.pop("prefill_last_logits")
        finite = bool(torch.isfinite(last).all())
        del last
        torch.cuda.empty_cache()
        gen2 = serve.main(serve_argv(), cfg=cfg)
        same = torch.equal(gen, gen2)
        run = dict(arch=arch, dtype=cfg.dtype, layers=cfg.n_layers,
                   block_pattern=list(cfg.block_pattern),
                   d_model=cfg.d_model, batch=LM_BATCH, prompt=LM_PROMPT,
                   gen=LM_GEN, wall_s=wall, peak_memory_gb=peak_gb,
                   parameters=None, logits_finite=finite,
                   same_tokens_twice=same, launches=counts,
                   flash_launches_by_body=bodies,
                   rwkv_launches_by_pass=passes,
                   sample=gen[0, :12].tolist(), **stats)
        torch.cuda.empty_cache()

        # hand-over: prefill(prompt + t0)[-1] against decode(t0) at P
        model = init_model(cfg, LM_SEED, "cuda")
        run["parameters"] = sum(p.numel() for p in model.parameters())
        g = torch.Generator(device="cuda").manual_seed(LM_SEED + 7)
        toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                             generator=g, device="cuda")
        cache = init_cache(cfg, LM_BATCH, LM_PROMPT + 1, "cuda")
        (logits, cache), trace = trace_call(
            torch, lambda: prefill(model, cfg, {"tokens": toks}, cache))
        t0 = logits[:, -1].argmax(-1)
        del logits
        (dec, cache), trace_dec = trace_call(
            torch, lambda: serve_step(model, cfg, cache, t0, LM_PROMPT))
        del cache
        full, _ = prefill(model, cfg,
                          {"tokens": torch.cat([toks, t0[:, None]], 1)},
                          init_cache(cfg, LM_BATCH, LM_PROMPT + 1, "cuda"))
        ref = full[:, -1]
        del full
        gap = float((dec - ref).abs().max())
        scale = float(ref.abs().max())
        run.update(handover_max_abs=gap, handover_logit_scale=scale,
                   handover_tol=LM_HANDOVER_TOL,
                   handover_same_argmax=float(
                       (dec.argmax(-1) == ref.argmax(-1)).float().mean()),
                   prefill_profile=trace, decode_step_profile=trace_dec)
        del model, dec, ref
        torch.cuda.empty_cache()
        record("lm_serve", **run)
        runs[arch] = run
        check(gen.shape == (LM_BATCH, LM_GEN), f"{arch}: generated "
                                                f"{tuple(gen.shape)}")
        check(finite, f"{arch}: non-finite prefill logits")
        check(same, f"{arch}: two runs gave different tokens")
        check(stats["prefill_launches"] == want,
              f"{arch}: prefill launches {stats['prefill_launches']} "
              f"(want {want})")
        check(not any(stats["decode_launches"].values()),
              f"{arch}: kernel launches in decode {stats['decode_launches']}")
        check(counts == want, f"{arch}: launches in the run {counts} "
                              f"(want {want})")
        check(bodies == {"wgmma": want["flash_attention"], "mma": 0,
                         "simt": 0},
              f"{arch}: flash launches by body {bodies}: every served one "
              f"on wgmma ({want['flash_attention']})")
        check(passes == dict.fromkeys(passes, want["rwkv6_scan"]),
              f"{arch}: rwkv6 passes {passes} (want {want['rwkv6_scan']} "
              f"each)")
        check(gap <= LM_HANDOVER_TOL * scale,
              f"{arch}: decode after prefill differs from the longer prefill "
              f"by {gap:.3g} > {LM_HANDOVER_TOL:g} x {scale:.3g}")
    return runs


def phase_lm_card_vs_cpu(torch):
    """The reduced configurations in float32: the same weights and tokens on
    the card (the kernels) and on the CPU (their plain versions); prefill
    logits and four decode steps' logits, each step fed the CPU's greedy
    token."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models.transformer import (init_cache, init_model,
                                                prefill, serve_step)

    rows = []
    # P is a multiple of neither the rwkv chunk (16) nor the ssm chunk (32)
    B, P, steps = 2, 40, 4
    for arch, kw in ((LM_DENSE, dict(kv_heads=2)), (LM_RWKV, {}),
                     (LM_HYBRID, dict(kv_heads=2)), (LM_MOE, {})):
        cfg = get_config(arch).reduced().replace(dtype="float32", **kw)
        toks = torch.randint(0, cfg.vocab_size, (B, P),
                             generator=torch.Generator().manual_seed(9))
        out, fed = {}, []
        for dev in ("cpu", "cuda"):
            model = init_model(cfg, LM_SEED, "cpu").to(dev)
            before = kops.launch_counts()
            cache = init_cache(cfg, B, P + steps, dev)
            logits, cache = prefill(model, cfg, {"tokens": toks.to(dev)},
                                    cache)
            after = kops.launch_counts()
            seq = [logits.cpu()]
            for i in range(steps):
                if dev == "cpu":
                    fed.append(seq[-1][:, -1].argmax(-1) if i == 0
                               else seq[-1].argmax(-1))
                d, cache = serve_step(model, cfg, cache, fed[i].to(dev),
                                      P + i)
                seq.append(d.cpu())
            out[dev] = (seq, {k: after[k] - before[k] for k in after})
        (cpu, cpu_n), (card, card_n) = out["cpu"], out["cuda"]
        gaps = [float((a - b).abs().max()) for a, b in zip(cpu, card)]
        same = all(torch.equal(a.argmax(-1), b.argmax(-1))
                   for a, b in zip(cpu, card))
        rows.append(dict(arch=arch, reduced=True, dtype="float32",
                         kv_heads=cfg.kv_heads, prompt=P, decode_steps=steps,
                         prefill_max_abs=gaps[0], decode_max_abs=gaps[1:],
                         tol=LM_CARD_CPU_TOL, same_argmax=same,
                         card_prefill_launches=card_n,
                         cpu_prefill_launches=cpu_n))
        check(max(gaps) <= LM_CARD_CPU_TOL and same,
              f"{arch} reduced: card vs CPU logits differ by {max(gaps):.3g}"
              f" (tol {LM_CARD_CPU_TOL:g}), same argmax {same}")
        check(card_n == prefill_launches(cfg) and not any(cpu_n.values()),
              f"{arch} reduced: kernel launches card {card_n}, cpu {cpu_n}")
    record("lm_card_vs_cpu", cases=rows)


# each kernel: its source in csrc/, the phase that holds it against its
# plain version (and its name), and its timing for the kernel_times record
KERNELS = {
    "sp1_lambda_sum": ("sp1_sweep", "sp1_kernel", phase_sp1_kernel, sp1_time),
    "waterfill_gprime": ("waterfill", "waterfill_kernel",
                         phase_waterfill_kernel, waterfill_time),
    "flash_attention": ("flash_attention", "flash_kernel",
                        phase_flash_kernel, flash_time),
    "rwkv6_scan": ("rwkv6_scan", "rwkv_kernel", phase_rwkv_kernel, rwkv_time),
    "mamba_scan": ("mamba_scan", "mamba_kernel", phase_mamba_kernel,
                   mamba_time),
}

if __name__ == "__main__":
    try:
        main()
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
