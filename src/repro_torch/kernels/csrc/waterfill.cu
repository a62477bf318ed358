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
// exactly): a 4-term branch-point series in p = sqrt(2 q) seeds up to 24
// Halley steps clamped at -1 + eps, with a tiny guard on Halley's
// denominator; where q < 1e-3 the series value is kept. eps and tiny are
// FLT_* / DBL_* by type.
//
// What bounds it: arithmetic. The function as the reference defines it
// runs 24 Halley steps per (m, n) pair (an exp, two divisions and ~10
// multiply-adds each) plus the seed's two logs and a sqrt, against 2 N + M
// input values per cell: at the region shape (C=1, M=128, N=131072) ~16.8 M
// pairs and 1 MB. Most of those steps repeat bits already computed, and
// where q < 1e-3 (44% of the region's pairs) the steps' value is not used.
//
// Design: run only the steps that change the result, exactly.
//   - A lane stops its Halley loop at the first iterate that repeats one
//     of the two before it bit for bit: a fixed point, or a two-cycle whose
//     24th iterate follows from the parity of the steps left. The tests are
//     bitwise, the same in float32 and float64, never a tolerance, and the
//     result is the 24-step one exactly. In float32 about 6% of the
//     region's lanes end in a two-cycle of their last bits (w + 1 is small
//     near the branch point and Halley's quotient amplifies the rounding of
//     f); with the fixed-point test alone nearly every warp held such a
//     lane and ran all 24 steps.
//   - A lane where q < 1e-3 returns the branch-point series, as the
//     reference selects it, without the steps; a lane computes only the
//     seed it uses (series, asymptotic logs, or the small-z polynomial).
//   - Every product of the seed and the Halley step goes through mul()
//     (__fmul_rn / __dmul_rn), which the compiler never contracts with an
//     add into a fused multiply-add, so the steps round every operation as
//     the plain version does. Fused rounding computes f = w e^w - z more
//     exactly, and then about half of the region's float32 lanes wander in
//     their last bits through all 24 steps without a short cycle.
// A warp runs as many steps as its slowest lane.
//
// The TPU kernel walked N in a sequential grid and carried the sum in its
// output block; here blocks run in parallel, so a grid of (N-chunk, cell)
// blocks gives one device to each thread, and the M candidates go by tiles
// of MT: per candidate a warp sums its 32 terms by a fixed shuffle
// butterfly, and per tile one barrier and one fixed-order pass over the
// warps' sums fill a (C, n_chunks, M) partials buffer (a tile of MT
// candidates costs one barrier, where a shared-memory tree per candidate
// cost log2(block) + 2). A second small kernel sums the partials in index
// order and subtracts B_total. No atomics: the dual search picks its bracket
// from the sign of these sums, so a sum must be the same on every run. Lanes
// past N add exactly 0. The clamps are explicit comparisons that propagate
// NaN like jnp.maximum / jnp.where (CUDA's fmax drops NaN). Built without
// fast math. Templated on float/double.

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
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
};
template <> struct Num<double> {
  __device__ static double eps() { return DBL_EPSILON; }
  __device__ static double tiny() { return DBL_MIN; }
  __device__ static double exp_(double x) { return exp(x); }
  __device__ static double log_(double x) { return log(x); }
  __device__ static double sqrt_(double x) { return sqrt(x); }
  __device__ static double abs_(double x) { return fabs(x); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
};

// jnp.maximum: a NaN in either operand gives NaN
template <typename T> __device__ __forceinline__ T jmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

constexpr double kE = 2.718281828459045;
constexpr double kLn2 = 0.6931471805599453;
constexpr int kHalleySteps = 24;  // the cap: _lambertw_vec's fixed count
constexpr int MT = 8;             // candidates per reduction tile

// The bits of a float or double, for the bitwise fixed-point test
__device__ __forceinline__ unsigned bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ unsigned long long bits(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(x));
}

// W0((q - 1)/e) for q >= 0, as _lambertw_vec computes it: its 24 Halley
// steps w_i = F(w_{i-1}) from the seed w_0, stopped at the first repeat.
// A step is a function of (w, zc) alone, so once w_i equals w_{i-1} bit for
// bit every later step returns the same bits, and once w_i equals w_{i-2}
// the iterates alternate between w_{i-1} and w_i for good: w_24 is then
// w_i if 24 - i is even and w_{i-1} if it is odd. Either way the result is
// the 24-step one exactly. Where q < 1e-3 the series value is the result
// and the steps are not taken; each lane computes only the seed it uses.
template <typename T> __device__ T lambertw_of_ratio(T q) {
  using N = Num<T>;
  const T eps = N::eps();
  const T tiny = N::tiny();
  const T qc = jmax(q, T(0));
  const T zc = (qc - T(1)) / T(kE);
  const bool series = qc < T(1e-3);
  T w;
  if (series || zc < T(-0.25)) {
    const T p = N::sqrt_(N::mul(T(2), qc));
    w = T(-1) + N::mul(p, T(1) - p / T(3)
                              + N::mul(N::mul(T(11), p), p) / T(72)
                              - N::mul(N::mul(N::mul(T(43), p), p), p)
                                    / T(540));
    if (series) return w;
  } else if (zc > T(3)) {
    const T lz = N::log_(jmax(zc, tiny));
    const T llz = N::log_(jmax(lz, tiny));
    w = lz - llz + llz / jmax(lz, eps);
  } else {
    w = N::mul(zc, T(1) - zc + N::mul(N::mul(T(1.5), zc), zc));
  }
  w = jmax(w, T(-1) + eps);
  T w_prev = w;  // w_{i-2}, read from i = 2 on
#pragma unroll 1
  for (int i = 1; i <= kHalleySteps; ++i) {
    const T ew = N::exp_(w);
    const T f = N::mul(w, ew) - zc;
    const T wp1 = w + T(1);
    const T denom = N::mul(ew, wp1)
                    - N::mul(w + T(2), f) / N::mul(T(2), wp1);
    const T d = (N::abs_(denom) < tiny) ? tiny : denom;
    const T w_next = jmax(w - f / d, T(-1) + eps);  // w_i; w is w_{i-1}
    if (bits(w_next) == bits(w)) break;
    if (i >= 2 && bits(w_next) == bits(w_prev)) {
      if (((kHalleySteps - i) & 1) == 0) w = w_next;
      break;
    }
    w_prev = w;
    w = w_next;
  }
  return w;
}

// grid (n_chunks, C), blockDim.x = block_n (a power of two, >= 32) devices.
// The candidates go by tiles of MT: each candidate's terms are summed over
// a warp by a fixed shuffle butterfly (lane 0 keeps the sum), the warps'
// sums land in shared memory, and after one barrier per tile thread m of
// the block adds the warps' sums of candidate m in warp order. The two
// halves of `red` alternate between tiles, so a tile's writes never meet
// the previous tile's reads.
template <typename T>
__global__ void waterfill_partial_kernel(const T* __restrict__ mu,
                                         const T* __restrict__ j,
                                         const T* __restrict__ rmin,
                                         T* __restrict__ partials, int M,
                                         int N) {
  __shared__ T red[2][32][MT];
  const int c = blockIdx.y;
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int warps = blockDim.x / 32;
  const int n = chunk * blockDim.x + tid;
  const bool live = n < N;

  const size_t row = static_cast<size_t>(c) * N;
  const T jn = live ? j[row + n] : T(1);
  const T rn = live ? rmin[row + n] : T(0);
  const T scale = rn * T(kLn2);
  const T floor = Num<T>::eps() * Num<T>::eps();
  const T* mu_c = mu + static_cast<size_t>(c) * M;
  T* out = partials + (static_cast<size_t>(c) * gridDim.x + chunk) * M;

  for (int m0 = 0, half = 0; m0 < M; m0 += MT, half ^= 1) {
    const int mt = min(MT, M - m0);
    for (int k = 0; k < mt; ++k) {
      T term = T(0);
      if (live)
        term = scale / jmax(lambertw_of_ratio(mu_c[m0 + k] / jn) + T(1),
                            floor);
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
  if (block_n < 32 || (block_n & (block_n - 1)) != 0 || block_n > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (N + block_n - 1) / block_n;
  waterfill_partial_kernel<T><<<dim3(n_chunks, C), block_n, 0, s>>>(
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
