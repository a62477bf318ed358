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
// What bounds it: arithmetic, not bytes. Each (m, n) pair costs 7 cbrt,
// 2 sqrt, 2 pow and about 20 divisions; the fleet's q and tt are 1 MB in f32.
// At the main path's C*M*N = 64*16*2048 the launch latency dominates.
//
// Design. The TPU kernel walked N in a sequential grid and carried the sum in
// its output block; here blocks run in parallel, so a grid of (N-chunk, cell)
// blocks gives one device to each thread, loops over the M candidates, and
// reduces each candidate with a fixed-order tree in shared memory into a
// (C, n_chunks, M) partials buffer; a second small kernel sums the partials in
// index order. No atomics: the sweep's bracket pick and the BCD iteration
// counts downstream compare sums, so a sum must be the same on every run.
// Lanes past N write exactly 0, as the TPU kernel's q = tt = 0 padding did.
// The clamps are explicit comparisons that propagate NaN like jnp.maximum /
// jnp.clip / jnp.min (CUDA's fmax/fmin drop NaN). Built without fast math:
// the tiny-guards and the cbrt/pow accuracy matter. Templated on float/double.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstddef>

namespace {

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ static float tiny() { return FLT_MIN; }
  __device__ static float cbrt_(float x) { return cbrtf(x); }
  __device__ static float sqrt_(float x) { return sqrtf(x); }
  __device__ static float pow_(float x, float y) { return powf(x, y); }
  __device__ static float abs_(float x) { return fabsf(x); }
};
template <> struct Num<double> {
  __device__ static double tiny() { return DBL_MIN; }
  __device__ static double cbrt_(double x) { return cbrt(x); }
  __device__ static double sqrt_(double x) { return sqrt(x); }
  __device__ static double pow_(double x, double y) { return pow(x, y); }
  __device__ static double abs_(double x) { return fabs(x); }
};

// jnp.maximum / jnp.minimum: a NaN in either operand gives NaN
template <typename T> __device__ __forceinline__ T jmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T jmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T jclip(T x, T lo, T hi) {
  return jmin(jmax(x, lo), hi);
}

template <typename T> struct Consts {
  T k3, rhok, f_min, f_max, s_lo, s_hi, lam_hi;
};

template <typename T>
__device__ T lambda_of_T(T Tm, T q, T tt, const Consts<T>& c) {
  using N = Num<T>;
  const T tiny = N::tiny();
  const T t_c = jmax(Tm - tt, tiny);            // target compute time
  const T q_safe = jmax(q, tiny);
  const T alpha = T(0.5) * c.k3 * q;
  const T k3_safe = jmax(c.k3, tiny);

  T cand[6];
  cand[0] = T(0);                               // already meets the deadline
  const T F[2] = {c.f_min, c.f_max};            // f pinned at a box edge
  for (int i = 0; i < 2; ++i) {
    const T s = N::sqrt_(t_c * F[i] / q_safe);
    cand[1 + i] = (c.rhok / jmax(s, tiny) - T(2) * alpha * (F[i] * F[i]))
                  * F[i] / (T(2) * q_safe);
  }
  const T S[2] = {c.s_lo, c.s_hi};              // s pinned at a box edge
  for (int i = 0; i < 2; ++i) {
    const T f = q * (S[i] * S[i]) / t_c;
    cand[3 + i] = c.k3 * (f * f * f);
  }
  // both interior, factored so alpha^2 never forms (it underflows f32)
  const T f6 = N::pow_(c.rhok / jmax(T(3) * c.k3, tiny), T(0.4))
               * N::pow_(jmax(q * t_c, tiny), T(-0.2));
  cand[5] = c.k3 * (f6 * f6 * f6);

  T err[6];
  for (int i = 0; i < 6; ++i) {
    const T l = (cand[i] != cand[i]) ? c.lam_hi : jclip(cand[i], T(0), c.lam_hi);
    cand[i] = l;
    const T f = jclip(N::cbrt_(l / k3_safe), c.f_min, c.f_max);
    const T fs = jmax(f, T(1e-9));
    const T psi = T(2) * alpha * (f * f) + T(2) * l * q / fs;
    const T s = jclip(c.rhok / jmax(psi, tiny), c.s_lo, c.s_hi);
    err[i] = N::abs_(q * (s * s) / fs - t_c);
  }
  T best = err[0];
  for (int i = 1; i < 6; ++i) best = jmin(best, err[i]);
  const T bar = best * T(1.0 + 1e-6) + tiny;
  T lam = T(INFINITY);
  for (int i = 0; i < 6; ++i)
    if (err[i] <= bar) lam = jmin(lam, cand[i]);
  // strictly unattainable deadline: saturate like the bisection does
  if (q * (c.s_lo * c.s_lo) / jmax(c.f_max, T(1e-9)) > t_c) lam = c.lam_hi;
  return lam;
}

// grid (n_chunks, C), blockDim.x = block_n (a power of two) devices
template <typename T>
__global__ void sp1_partial_kernel(const T* __restrict__ T_grid,
                                   const T* __restrict__ q,
                                   const T* __restrict__ tt,
                                   const T* __restrict__ consts,
                                   T* __restrict__ partials, int M, int N) {
  extern __shared__ unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);
  const int c = blockIdx.y;
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = chunk * blockDim.x + tid;
  const bool live = n < N;

  const T* k = consts + static_cast<size_t>(c) * 8;
  const Consts<T> cc{k[0], k[1], k[2], k[3], k[4], k[5], k[6]};
  const size_t row = static_cast<size_t>(c) * N;
  const T qn = live ? q[row + n] : T(0);
  const T ttn = live ? tt[row + n] : T(0);
  T* out = partials + (static_cast<size_t>(c) * gridDim.x + chunk) * M;

  for (int m = 0; m < M; ++m) {
    const T Tm = T_grid[static_cast<size_t>(c) * M + m];
    red[tid] = live ? lambda_of_T(Tm, qn, ttn, cc) : T(0);
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] += red[tid + s];
      __syncthreads();
    }
    if (tid == 0) out[m] = red[0];
    __syncthreads();
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
  if (block_n <= 0 || (block_n & (block_n - 1)) != 0 || block_n > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (N + block_n - 1) / block_n;
  sp1_partial_kernel<T><<<dim3(n_chunks, C), block_n, block_n * sizeof(T), s>>>(
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
