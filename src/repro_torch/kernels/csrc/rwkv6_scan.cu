// rwkv6_scan.cu — the chunked RWKV6 (Finch) WKV recurrence on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_scan
// (body _wkv_kernel). Its plain PyTorch twin is
// repro_torch/kernels/rwkv6_scan.py::rwkv6_scan_ref.
//
// What it computes, per batch b and head h, from a zero state S (K x K):
//   o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T
// with w_t = exp(logw_t), chunk by chunk in the parallel form: with clw the
// inclusive and clw' the exclusive cumulative log decay of the chunk,
//   o_t = (r_t o exp(clw'_t)) S + sum_{tau<t} A[t,tau] v_tau + (sum_k r u k)_t v_t,
//   A[t,tau] = sum_k r_{t,k} k_{tau,k} exp(clw'_{t,k} - clw_{tau,k}),
//   S <- exp(clw_L) o S + (exp(clw_L - clw) o k)^T v,
// every exponent <= 0, so no decay strength overflows. r, k, v, logw
// (B,T,H,K) float32, read through their strides (last dimension contiguous);
// u (H,K). Writes o (B,T,H,K) and, unlike the TPU kernel (which kept the
// state in VMEM scratch and dropped it), the final state (B,H,K,K) that the
// decode cache needs.
//
// What bounds it: bytes. At rwkv6-1.6b's prefill shape (4,2048,32,64) it
// moves ~338 MB (0.10 ms at 3.35 TB/s), while the recurrence needs ~5.5
// GFLOP (0.08 ms at the float32 rate). The chunked form here does more
// (~0.5 G pairwise exponentials and ~3.2 G MAC with chunks of 64).
//
// Design. One block of 256 threads per (h, b) walks the chunks in order,
// the state in shared memory; at B = 4, H = 32 that is 128 blocks for 132
// SMs (splitting V across blocks is later work). Per chunk the r, k, v and
// logw tiles go to shared memory (rows padded to K + 1 words, so a warp's
// column reads hit distinct banks); K threads scan the log decays; each
// thread owns a strided (L/16) x (L/16) block of A, and (K/16)-wide blocks
// of the output rows and of the state, accumulating in registers. Only the
// A blocks on or below the diagonal are computed. Positions past T are
// zero-padded in shared memory (r = k = v = 0, logw = 0): they leave the
// state unchanged and are not written. No atomics: each block owns its
// (b, h), so two launches are bitwise equal. Built without fast math.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16

// element strides of r, k, v, logw: (batch, time, head) each
struct Strides {
  long long s[12];
};

template <int L, int K>
__global__ void __launch_bounds__(THREADS, 1)
rwkv6_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, float* __restrict__ o,
                 float* __restrict__ s_out, int T, int H, const Strides sd) {
  const long long* st = sd.s;
  constexpr int P = K + 1;    // padded tile row
  constexpr int PA = L + 1;   // padded row of A
  constexpr int TM = L / 16;  // A rows / cols per thread
  constexpr int TV = K / 16;  // output / state cols per thread
  extern __shared__ float sm[];
  float* rs = sm;              // [L][P] r, then r * exp(clw')
  float* ks = rs + L * P;      // [L][P] k, then exp(clw_L - clw) * k
  float* vs = ks + L * P;      // [L][P] v
  float* ws = vs + L * P;      // [L][P] logw, then clw' (exclusive)
  float* cs = ws + L * P;      // [L][P] clw (inclusive)
  float* As = cs + L * P;      // [L][PA] intra-chunk scores, tau < t
  float* Ss = As + L * PA;     // [K][P] state
  float* bonus = Ss + K * P;   // [L]  sum_k r u k
  float* us = bonus + L;       // [K]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // strides (elements) of r, k, v, logw: batch, time, head each
  const float* src[4] = {r + b * st[0] + h * st[2], k + b * st[3] + h * st[5],
                         v + b * st[6] + h * st[8], lw + b * st[9] + h * st[11]};
  const long long tstride[4] = {st[1], st[4], st[7], st[10]};
  float* dst[4] = {rs, ks, vs, ws};

  for (int i = tid; i < K * P; i += THREADS) Ss[i] = 0.f;
  for (int i = tid; i < K; i += THREADS) us[i] = u[h * K + i];

  for (int c0 = 0; c0 < T; c0 += L) {
    __syncthreads();  // the previous chunk's reads are done
#pragma unroll
    for (int a = 0; a < 4; ++a)
      for (int i = tid; i < L * K; i += THREADS) {
        const int t = i / K, kk = i % K;
        dst[a][t * P + kk] =
            c0 + t < T ? src[a][(c0 + t) * tstride[a] + kk] : 0.f;
      }
    __syncthreads();

    for (int kk = tid; kk < K; kk += THREADS) {
      float acc = 0.f;
      for (int t = 0; t < L; ++t) {
        const float w = ws[t * P + kk];
        acc += w;
        cs[t * P + kk] = acc;
        ws[t * P + kk] = acc - w;
      }
    }
    for (int t = tid; t < L; t += THREADS) {
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk)
        acc += rs[t * P + kk] * us[kk] * ks[t * P + kk];
      bonus[t] = acc;
    }
    __syncthreads();

    // A[t][tau], t = ty + 16 i, tau = tx + 16 j; zero on and above the diagonal
    {
      float acc[TM][TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        float rr[TM], cp[TM], kv[TM], cl[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          rr[i] = rs[(ty + 16 * i) * P + kk];
          cp[i] = ws[(ty + 16 * i) * P + kk];
          kv[i] = ks[(tx + 16 * i) * P + kk];
          cl[i] = cs[(tx + 16 * i) * P + kk];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j)
            if (j < i || tx < ty)
              acc[i][j] += rr[i] * kv[j] * expf(cp[i] - cl[j]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j)
          As[(ty + 16 * i) * PA + tx + 16 * j] =
              (j < i || (j == i && tx < ty)) ? acc[i][j] : 0.f;
    }
    __syncthreads();  // r and k are read: fold the decays into them

    for (int i = tid; i < L * K; i += THREADS) {
      const int t = i / K, kk = i % K;
      rs[t * P + kk] *= expf(ws[t * P + kk]);
      ks[t * P + kk] *= expf(cs[(L - 1) * P + kk] - cs[t * P + kk]);
    }
    __syncthreads();

    // o[t][vv], t = ty + 16 i, vv = tx + 16 j
    {
      float acc[TM][TV];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TV; ++j) acc[i][j] = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        float a[TM], sv[TV];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = rs[(ty + 16 * i) * P + kk];
#pragma unroll
        for (int j = 0; j < TV; ++j) sv[j] = Ss[kk * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TV; ++j) acc[i][j] += a[i] * sv[j];
      }
      for (int tau = 0; tau < L; ++tau) {
        float a[TM], vv[TV];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[(ty + 16 * i) * PA + tau];
#pragma unroll
        for (int j = 0; j < TV; ++j) vv[j] = vs[tau * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TV; ++j) acc[i][j] += a[i] * vv[j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int t = ty + 16 * i;
        if (c0 + t >= T) continue;
        float* orow = o + ((static_cast<long long>(b) * T + c0 + t) * H + h) * K;
#pragma unroll
        for (int j = 0; j < TV; ++j) {
          const int vv = tx + 16 * j;
          orow[vv] = acc[i][j] + bonus[t] * vs[t * P + vv];
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // S[kk][vv], kk = ty + 16 i, vv = tx + 16 j
    {
      float acc[TV][TV];
#pragma unroll
      for (int i = 0; i < TV; ++i)
#pragma unroll
        for (int j = 0; j < TV; ++j) acc[i][j] = 0.f;
      for (int tau = 0; tau < L; ++tau) {
        float a[TV], vv[TV];
#pragma unroll
        for (int i = 0; i < TV; ++i) a[i] = ks[tau * P + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TV; ++j) vv[j] = vs[tau * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TV; ++i)
#pragma unroll
          for (int j = 0; j < TV; ++j) acc[i][j] += a[i] * vv[j];
      }
#pragma unroll
      for (int i = 0; i < TV; ++i) {
        const int kk = ty + 16 * i;
        const float wL = expf(cs[(L - 1) * P + kk]);
#pragma unroll
        for (int j = 0; j < TV; ++j) {
          float* s = &Ss[kk * P + tx + 16 * j];
          *s = wL * *s + acc[i][j];
        }
      }
    }
  }
  __syncthreads();
  float* so = s_out + (static_cast<long long>(b) * H + h) * K * K;
  for (int i = tid; i < K * K; i += THREADS) so[i] = Ss[(i / K) * P + i % K];
}

template <int L, int K>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, float* o, float* s_out, int B, int T, int H,
           const long long* st, cudaStream_t stream) {
  constexpr int P = K + 1;
  const size_t smem =
      sizeof(float) * (5 * L * P + L * (L + 1) + K * P + L + K);
  auto kern = rwkv6_fwd_kernel<L, K>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  Strides sd;
  for (int i = 0; i < 12; ++i) sd.s[i] = st[i];
  kern<<<dim3(H, B), THREADS, smem, stream>>>(r, k, v, lw, u, o, s_out, T, H,
                                              sd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// strides (elements): r b/t/h, k b/t/h, v b/t/h, logw b/t/h.
// chunk and K each in {16, 32, 64}. Returns a cudaError_t.
int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, void* o, void* s_out,
                   int B, int T, int H, int K, int chunk,
                   const long long* strides, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a[5] = {static_cast<const float*>(r),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v),
                       static_cast<const float*>(logw),
                       static_cast<const float*>(u)};
  float* out = static_cast<float*>(o);
  float* so = static_cast<float*>(s_out);
#define RWKV_CASE(LL, KK)                                                  \
  if (chunk == LL && K == KK)                                              \
    return launch<LL, KK>(a[0], a[1], a[2], a[3], a[4], out, so, B, T, H,  \
                          strides, s);
  RWKV_CASE(16, 16) RWKV_CASE(16, 32) RWKV_CASE(16, 64)
  RWKV_CASE(32, 16) RWKV_CASE(32, 32) RWKV_CASE(32, 64)
  RWKV_CASE(64, 16) RWKV_CASE(64, 32) RWKV_CASE(64, 64)
#undef RWKV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rwkv6_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
