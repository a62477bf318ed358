// sp1_sweep.cu — the SP1 dual sweep Sigma_n lambda_n(T) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sp1_sweep.py::sp1_lambda_sum
// (body _sp1_kernel, math lambda_of_T_linear). Its plain PyTorch twin is
// repro_torch/kernels/sp1_sweep.py::lambda_of_T_linear / sp1_lambda_sum_ref.
//
// What it computes: for every cell c and candidate deadline T_m, the sum over
// the cell's N devices of the exact LinearAccuracy inverse lambda_n(T_m):
// six clip-regime candidates, NaN -> lam_hi, a clip to [0, lam_hi], the exact
// forward makespan of each, the smallest lambda within 1e-6 of the best error,
// and saturation to lam_hi when the deadline cannot be met.
//   T_grid (C, M), q / tt (C, N), consts (C, 8) -> out (C, M)
//   consts row: [k3, rho*slope, f_min, f_max, s_lo, s_hi, lam_hi, unused]
//
// What bounds it: arithmetic, not bytes. The fleet's q and tt are 1 MB in
// float32, against C*M*N = 64*16*2048 = 2.1 M (m, n) pairs of about 220
// operations each as the plain version writes them. On this card the time
// goes to instruction issue: divisions, cube roots and powers written the
// IEEE way are long instruction sequences, and block shape and occupancy
// hardly move the time.
//
// Design: issue fewer instructions per pair, and sum in a fixed order.
//   - Exact hoists. A thread keeps one device for all M candidates, and
//     everything that depends only on the cell or the device is computed
//     once: k3_safe, (rhok / max(3 k3, tiny))^0.4, the squared box edges,
//     q_safe, 2 alpha, 2 alpha F^2, 2 q_safe, q S^2, the makespan floor, and
//     the whole forward makespan of the lambda = 0 candidate (at lambda = 0
//     the cube root is 0 and clips to f_min, so only |mk0 - t_c| depends on
//     the candidate). The same expression on the same operands gives the same
//     bits. Where the floor exceeds t_c the result is lam_hi whatever the
//     candidates give, and the lane skips them.
//   - float32 only, cheaper forms (Num<float>): each division of a pair is
//     a product with a reciprocal (IEEE 1 / b once per device for q_safe and
//     2 q_safe and once per cell for k3_safe; rcp.approx once per pair for
//     t_c and per candidate for f and psi), the cube root and x^-0.2 go
//     through lg2.approx and ex2.approx, and rhok / sqrt(x) through
//     rsqrt.approx. Each is a few ulps from the IEEE result; the sums stay
//     well inside the float32 tolerance of 1e-4 and pick the same sweep
//     bracket. The clamps are max.NaN / min.NaN, which propagate NaN as
//     jnp.maximum does, in one instruction. float64 keeps IEEE division,
//     cbrt, pow and sqrt.
//   - Exact ties stay exact. Candidates whose f and s clip to the same
//     corner of the box have the same makespan to the bit in the plain
//     version, and the smallest lambda wins the tie. So each float32
//     reciprocal product is rounded on its own (__fmul_rn, never fused into
//     a multiply-add), and the lambda = 0 candidate takes the same rcp of f
//     as the others: a product fused in one candidate's copy of the code and
//     not in another's breaks such a tie through the cancellation in
//     |mk - t_c| (a build that let the compiler fuse them picked the larger
//     lambda for some devices of the w1 = 0 fleet in float32).
//   - Fixed-order sums, no atomics. A grid of (N-chunk, cell) blocks; the
//     candidates go by tiles of kTile: per candidate a warp sums its 32 terms
//     by a fixed shuffle butterfly, per tile one barrier and one pass over
//     the warps' sums in warp order fill a (C, n_chunks, M) partials buffer,
//     and a second small kernel sums the partials in index order. The sweep's
//     bracket pick and the BCD iteration counts downstream compare sums, so
//     equal inputs give equal bits on every run. Lanes past N add exactly 0.
// Built without fast math (the float64 path and the per-cell pow need IEEE
// arithmetic). Templated on float/double.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kMaxBlock = 256;           // devices a block, one a thread
constexpr int kMaxWarps = kMaxBlock / 32;
constexpr int kTile = 16;                // candidates per barrier

// float32 approximations (PTX, one instruction each, subnormals flushed)
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// jnp.maximum / jnp.minimum: a NaN in either operand gives NaN
__device__ __forceinline__ float jmax(float a, float b) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
  return y;
}
__device__ __forceinline__ float jmin(float a, float b) {
  float y;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
  return y;
}
__device__ __forceinline__ double jmax(double a, double b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ double jmin(double a, double b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T jclip(T x, T lo, T hi) {
  return jmin(jmax(x, lo), hi);
}

// div(a, b, rb) is a / b, given a reciprocal rb of b: float32 takes the
// product, rounded on its own (__fmul_rn is never fused into a multiply-add),
// as the quotient is; float64 the IEEE quotient (and drops rb). rcp is the
// reciprocal of a pair's t_c, f and psi; the per-cell and per-device ones
// are IEEE 1 / b in both types.
template <typename T> struct Num;
template <> struct Num<float> {
  __device__ static float tiny() { return FLT_MIN; }
  __device__ static float rcp(float b) { return rcp_approx(b); }
  __device__ static float div(float a, float, float rb) {
    return __fmul_rn(a, rb);
  }
  __device__ static float cbrt_(float x) {
    return ex2_approx(lg2_approx(x) * (1.0f / 3.0f));
  }
  __device__ static float pow_m02(float x) {
    return ex2_approx(-0.2f * lg2_approx(x));
  }
  // a / max(sqrt(x), tiny); 0x1p126f = 1 / FLT_MIN
  __device__ static float over_sqrt(float a, float x) {
    return a * jmin(rsqrt_approx(x), 0x1p126f);
  }
};
template <> struct Num<double> {
  __device__ static double tiny() { return DBL_MIN; }
  __device__ static double rcp(double b) { return 1.0 / b; }
  __device__ static double div(double a, double b, double) { return a / b; }
  __device__ static double cbrt_(double x) { return cbrt(x); }
  __device__ static double pow_m02(double x) { return pow(x, -0.2); }
  __device__ static double over_sqrt(double a, double x) {
    return a / jmax(sqrt(x), DBL_MIN);
  }
};

// what depends only on the cell
template <typename T> struct Cell {
  T k3, rhok, F[2], S[2], lam_hi;
  T k3_safe, rk3, f6_cell, FF[2], SS[2], lam0, f0, fs0, rfs0, fmax_safe;

  __device__ explicit Cell(const T* k) {
    using N = Num<T>;
    const T tiny = N::tiny();
    k3 = k[0];
    rhok = k[1];
    F[0] = k[2];
    F[1] = k[3];
    S[0] = k[4];
    S[1] = k[5];
    lam_hi = k[6];
    k3_safe = jmax(k3, tiny);
    rk3 = T(1) / k3_safe;
    f6_cell = pow(rhok / jmax(T(3) * k3, tiny), T(0.4));
    for (int i = 0; i < 2; ++i) {
      FF[i] = F[i] * F[i];
      SS[i] = S[i] * S[i];
    }
    lam0 = jclip(T(0), T(0), lam_hi);              // the lambda = 0 candidate
    f0 = jclip(N::cbrt_(N::div(lam0, k3_safe, rk3)), F[0], F[1]);
    fs0 = jmax(f0, T(1e-9));
    rfs0 = N::rcp(fs0);                            // as every candidate's
    fmax_safe = jmax(F[1], T(1e-9));
  }

  // q s^2 / f through the exact forward map at lambda l, whose f is given
  __device__ T makespan(T l, T f, T fs, T rfs, T q, T two_alpha) const {
    using N = Num<T>;
    const T psi = two_alpha * (f * f) + N::div(T(2) * l * q, fs, rfs);
    const T psi_safe = jmax(psi, N::tiny());
    const T s = jclip(N::div(rhok, psi_safe, N::rcp(psi_safe)), S[0], S[1]);
    return N::div(q * (s * s), fs, rfs);
  }
};

// what depends only on the device (and its cell)
template <typename T> struct Device {
  T q, tt, q_safe, rq, two_alpha, a2F[2], two_q, r2q, qSS[2], floor, mk0;

  __device__ Device(const Cell<T>& c, T q_, T tt_) : q(q_), tt(tt_) {
    using N = Num<T>;
    q_safe = jmax(q, N::tiny());
    rq = T(1) / q_safe;
    const T alpha = T(0.5) * c.k3 * q;
    two_alpha = T(2) * alpha;
    for (int i = 0; i < 2; ++i) {
      a2F[i] = two_alpha * c.FF[i];
      qSS[i] = q * c.SS[i];
    }
    two_q = T(2) * q_safe;
    r2q = T(1) / two_q;
    floor = qSS[0] / c.fmax_safe;
    mk0 = c.makespan(c.lam0, c.f0, c.fs0, c.rfs0, q, two_alpha);
  }
};

template <typename T>
__device__ T lambda_of_T(T Tm, const Cell<T>& c, const Device<T>& d) {
  using N = Num<T>;
  const T tiny = N::tiny();
  const T t_c = jmax(Tm - d.tt, tiny);          // target compute time
  // strictly unattainable deadline: saturate like the bisection does
  if (d.floor > t_c) return c.lam_hi;
  const T rt = N::rcp(t_c);

  T cand[5];
  for (int i = 0; i < 2; ++i) {                 // f pinned at a box edge
    const T x = N::div(t_c * c.F[i], d.q_safe, d.rq);
    cand[i] = N::div((N::over_sqrt(c.rhok, x) - d.a2F[i]) * c.F[i], d.two_q,
                     d.r2q);
  }
  for (int i = 0; i < 2; ++i) {                 // s pinned at a box edge
    const T f = N::div(d.qSS[i], t_c, rt);
    cand[2 + i] = c.k3 * (f * f * f);
  }
  // both interior, factored so alpha^2 never forms (it underflows f32)
  const T f6 = c.f6_cell * N::pow_m02(jmax(d.q * t_c, tiny));
  cand[4] = c.k3 * (f6 * f6 * f6);

  const T err0 = fabs(d.mk0 - t_c);
  T err[5];
  T best = err0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const T l = (cand[i] != cand[i]) ? c.lam_hi
                                     : jclip(cand[i], T(0), c.lam_hi);
    cand[i] = l;
    const T f = jclip(N::cbrt_(N::div(l, c.k3_safe, c.rk3)), c.F[0], c.F[1]);
    const T fs = jmax(f, T(1e-9));
    err[i] = fabs(c.makespan(l, f, fs, N::rcp(fs), d.q, d.two_alpha) - t_c);
    best = jmin(best, err[i]);
  }
  const T bar = best * T(1.0 + 1e-6) + tiny;
  T lam = (err0 <= bar) ? c.lam0 : T(INFINITY);
#pragma unroll
  for (int i = 0; i < 5; ++i)
    if (err[i] <= bar) lam = jmin(lam, cand[i]);
  return lam;
}

// grid (n_chunks, C), blockDim.x = block_n (a power of two, 32 to kMaxBlock)
// devices. The candidates go by tiles of kTile: each candidate's terms are
// summed over a warp by a fixed shuffle butterfly (lane 0 keeps the sum), the
// warps' sums land in shared memory, and after one barrier per tile thread m
// of the block adds the warps' sums of candidate m in warp order. The two
// halves of `red` alternate between tiles, so a tile's writes never meet the
// previous tile's reads.
template <typename T>
__global__ void __launch_bounds__(kMaxBlock)
sp1_partial_kernel(const T* __restrict__ T_grid, const T* __restrict__ q,
                   const T* __restrict__ tt, const T* __restrict__ consts,
                   T* __restrict__ partials, int M, int N) {
  __shared__ T red[2][kMaxWarps][kTile];
  const int c = blockIdx.y;
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int warps = blockDim.x / 32;
  const int n = chunk * blockDim.x + tid;
  const bool live = n < N;

  const Cell<T> cell(consts + static_cast<size_t>(c) * 8);
  const size_t row = static_cast<size_t>(c) * N;
  const Device<T> dev(cell, live ? q[row + n] : T(0),
                      live ? tt[row + n] : T(0));
  const T* T_row = T_grid + static_cast<size_t>(c) * M;
  T* out = partials + (static_cast<size_t>(c) * gridDim.x + chunk) * M;

  for (int m0 = 0, half = 0; m0 < M; m0 += kTile, half ^= 1) {
    const int mt = min(kTile, M - m0);
    // one (m, n) pair a trip (chip_smoke.py's SASS count reads this loop)
#pragma unroll 1
    for (int k = 0; k < mt; ++k) {
      T term = T(0);
      if (live) term = lambda_of_T(T_row[m0 + k], cell, dev);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        term += __shfl_down_sync(0xffffffffu, term, off);
      if (lane == 0) red[half][warp][k] = term;
    }
    __syncthreads();
    if (tid < mt) {
      T acc = red[half][0][tid];
      for (int w = 1; w < warps; ++w) acc += red[half][w][tid];
      out[m0 + tid] = acc;
    }
  }
}

// one thread per (c, m): the chunks' partial sums in index order
template <typename T>
__global__ void sp1_final_kernel(const T* __restrict__ partials,
                                 T* __restrict__ out, int C, int M,
                                 int n_chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * M) return;
  const int c = i / M;
  const int m = i % M;
  const T* p = partials + static_cast<size_t>(c) * n_chunks * M + m;
  T acc = T(0);
  for (int j = 0; j < n_chunks; ++j) acc += p[static_cast<size_t>(j) * M];
  out[i] = acc;
}

template <typename T>
int launch(const void* T_grid, const void* q, const void* tt,
           const void* consts, void* partials, void* out, int C, int M, int N,
           int block_n, void* stream) {
  if (block_n < 32 || (block_n & (block_n - 1)) != 0 || block_n > kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (N + block_n - 1) / block_n;
  sp1_partial_kernel<T><<<dim3(n_chunks, C), block_n, 0, s>>>(
      static_cast<const T*>(T_grid), static_cast<const T*>(q),
      static_cast<const T*>(tt), static_cast<const T*>(consts),
      static_cast<T*>(partials), M, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = 128;
  sp1_final_kernel<T><<<(C * M + threads - 1) / threads, threads, 0, s>>>(
      static_cast<const T*>(partials), static_cast<T*>(out), C, M, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sp1_lambda_sum_f32(const void* T_grid, const void* q, const void* tt,
                       const void* consts, void* partials, void* out, int C,
                       int M, int N, int block_n, void* stream) {
  return launch<float>(T_grid, q, tt, consts, partials, out, C, M, N, block_n,
                       stream);
}

int sp1_lambda_sum_f64(const void* T_grid, const void* q, const void* tt,
                       const void* consts, void* partials, void* out, int C,
                       int M, int N, int block_n, void* stream) {
  return launch<double>(T_grid, q, tt, consts, partials, out, C, M, N, block_n,
                        stream);
}

const char* sp1_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
