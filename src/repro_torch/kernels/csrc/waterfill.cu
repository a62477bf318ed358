// waterfill.cu — the SP2 dual sweep g'(mu) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/waterfill.py::waterfill_gprime
// (body _waterfill_kernel, math _lambertw_vec). Its plain PyTorch twin is
// repro_torch/kernels/waterfill.py::_lambertw_vec / waterfill_gprime_ref.
//
// What it computes (paper eq. A.23): for every cell c and candidate
// multiplier mu_m,
//   g'(mu_m) = sum_n rmin_n ln2 / max(W0((mu_m - j_n)/(e j_n)) + 1, eps^2)
//              - B_total_c
//   mu (C, M), j / rmin (C, N), B_total (C,) -> out (C, M)
// W0 is evaluated on the cancellation-free ratio q = mu / j (e z + 1 = q
// exactly): a 4-term branch-point series in p = sqrt(2 q) seeds 24 Halley
// steps clamped at -1 + eps, with a tiny guard on Halley's denominator; where
// q < 1e-3 the series value is kept. eps and tiny are FLT_* / DBL_* by type.
//
// What bounds it: arithmetic. Each (m, n) pair costs 24 Halley steps (an exp,
// two divisions and ~10 multiply-adds each) plus the seed's two logs and a
// sqrt; the inputs are 2 N + M values per cell. At the region shape
// (C=1, M=128, N=131072) that is ~16.8 M pairs against 1 MB of inputs.
//
// Design. The TPU kernel walked N in a sequential grid and carried the sum in
// its output block; here blocks run in parallel, so a grid of (N-chunk, cell)
// blocks gives one device to each thread, loops over the M candidates, and
// reduces each candidate with a fixed-order tree in shared memory into a
// (C, n_chunks, M) partials buffer; a second small kernel sums the partials in
// index order and subtracts B_total. No atomics: the dual search picks its
// bracket from the sign of these sums, so a sum must be the same on every
// run. Lanes past N write exactly 0. The clamps are explicit comparisons that
// propagate NaN like jnp.maximum / jnp.where (CUDA's fmax drops NaN). Built
// without fast math. Templated on float/double.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstddef>

namespace {

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ static float eps() { return FLT_EPSILON; }
  __device__ static float tiny() { return FLT_MIN; }
  __device__ static float exp_(float x) { return expf(x); }
  __device__ static float log_(float x) { return logf(x); }
  __device__ static float sqrt_(float x) { return sqrtf(x); }
  __device__ static float abs_(float x) { return fabsf(x); }
};
template <> struct Num<double> {
  __device__ static double eps() { return DBL_EPSILON; }
  __device__ static double tiny() { return DBL_MIN; }
  __device__ static double exp_(double x) { return exp(x); }
  __device__ static double log_(double x) { return log(x); }
  __device__ static double sqrt_(double x) { return sqrt(x); }
  __device__ static double abs_(double x) { return fabs(x); }
};

// jnp.maximum: a NaN in either operand gives NaN
template <typename T> __device__ __forceinline__ T jmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

constexpr double kE = 2.718281828459045;
constexpr double kLn2 = 0.6931471805599453;

// W0((q - 1)/e) for q >= 0, as _lambertw_vec computes it
template <typename T> __device__ T lambertw_of_ratio(T q) {
  using N = Num<T>;
  const T eps = N::eps();
  const T tiny = N::tiny();
  const T qc = jmax(q, T(0));
  const T zc = (qc - T(1)) / T(kE);
  const T p = N::sqrt_(T(2) * qc);
  const T w_branch = T(-1) + p * (T(1) - p / T(3) + T(11) * p * p / T(72)
                                  - T(43) * p * p * p / T(540));
  const T lz = N::log_(jmax(zc, tiny));
  const T llz = N::log_(jmax(lz, tiny));
  const T w_big = lz - llz + llz / jmax(lz, eps);
  const T w_small = zc * (T(1) - zc + T(1.5) * zc * zc);
  T w = (zc < T(-0.25)) ? w_branch : ((zc > T(3)) ? w_big : w_small);
  w = jmax(w, T(-1) + eps);
  for (int i = 0; i < 24; ++i) {
    const T ew = N::exp_(w);
    const T f = w * ew - zc;
    const T wp1 = w + T(1);
    const T denom = ew * wp1 - (w + T(2)) * f / (T(2) * wp1);
    const T d = (N::abs_(denom) < tiny) ? tiny : denom;
    w = jmax(w - f / d, T(-1) + eps);
  }
  return (qc < T(1e-3)) ? w_branch : w;
}

// grid (n_chunks, C), blockDim.x = block_n (a power of two) devices
template <typename T>
__global__ void waterfill_partial_kernel(const T* __restrict__ mu,
                                         const T* __restrict__ j,
                                         const T* __restrict__ rmin,
                                         T* __restrict__ partials, int M,
                                         int N) {
  extern __shared__ unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);
  const int c = blockIdx.y;
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = chunk * blockDim.x + tid;
  const bool live = n < N;

  const size_t row = static_cast<size_t>(c) * N;
  const T jn = live ? j[row + n] : T(1);
  const T rn = live ? rmin[row + n] : T(0);
  const T scale = rn * T(kLn2);
  const T floor = Num<T>::eps() * Num<T>::eps();
  T* out = partials + (static_cast<size_t>(c) * gridDim.x + chunk) * M;

  for (int m = 0; m < M; ++m) {
    const T mu_m = mu[static_cast<size_t>(c) * M + m];
    T term = T(0);
    if (live) term = scale / jmax(lambertw_of_ratio(mu_m / jn) + T(1), floor);
    red[tid] = term;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
      if (tid < s) red[tid] += red[tid + s];
      __syncthreads();
    }
    if (tid == 0) out[m] = red[0];
    __syncthreads();
  }
}

// one thread per (c, m): the chunks' partial sums in index order, less B_total
template <typename T>
__global__ void waterfill_final_kernel(const T* __restrict__ partials,
                                       const T* __restrict__ B_total,
                                       T* __restrict__ out, int C, int M,
                                       int n_chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * M) return;
  const int c = i / M;
  const int m = i % M;
  const T* p = partials + static_cast<size_t>(c) * n_chunks * M + m;
  T acc = T(0);
  for (int k = 0; k < n_chunks; ++k) acc += p[static_cast<size_t>(k) * M];
  out[i] = acc - B_total[c];
}

template <typename T>
int launch(const void* mu, const void* j, const void* rmin,
           const void* B_total, void* partials, void* out, int C, int M, int N,
           int block_n, void* stream) {
  if (block_n <= 0 || (block_n & (block_n - 1)) != 0 || block_n > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (N + block_n - 1) / block_n;
  waterfill_partial_kernel<T>
      <<<dim3(n_chunks, C), block_n, block_n * sizeof(T), s>>>(
          static_cast<const T*>(mu), static_cast<const T*>(j),
          static_cast<const T*>(rmin), static_cast<T*>(partials), M, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = 128;
  waterfill_final_kernel<T><<<(C * M + threads - 1) / threads, threads, 0, s>>>(
      static_cast<const T*>(partials), static_cast<const T*>(B_total),
      static_cast<T*>(out), C, M, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int waterfill_gprime_f32(const void* mu, const void* j, const void* rmin,
                         const void* B_total, void* partials, void* out, int C,
                         int M, int N, int block_n, void* stream) {
  return launch<float>(mu, j, rmin, B_total, partials, out, C, M, N, block_n,
                       stream);
}

int waterfill_gprime_f64(const void* mu, const void* j, const void* rmin,
                         const void* B_total, void* partials, void* out, int C,
                         int M, int N, int block_n, void* stream) {
  return launch<double>(mu, j, rmin, B_total, partials, out, C, M, N, block_n,
                        stream);
}

const char* waterfill_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
