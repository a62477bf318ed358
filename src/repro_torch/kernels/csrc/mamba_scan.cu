// mamba_scan.cu — the Mamba selective scan on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/mamba_scan.py::mamba_scan
// (body _mamba_kernel). Its plain PyTorch twin is
// repro_torch/kernels/mamba_scan.py::mamba_scan_ref.
//
// What it computes, per batch b, channel d and state n, from h = 0:
//   h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + (dt_t[d] B_t[n]) x_t[d]
//   y_t[d]    = sum_n h_t[d, n] C_t[n]
// dt, x (B,T,D) and Bt, Ct (B,T,N) float32, read through their batch and
// time strides (last dimension contiguous: Bt and Ct are the two halves of
// one (B,T,2N) projection); A (D,N) contiguous. Writes y (B,T,D) and,
// unlike the TPU kernel (which kept h in VMEM scratch and dropped it), the
// final state h_end (B,D,N) that the decode cache needs.
//
// What bounds it. At the jamba-1.5-large prefill shape (B,T,D,N) =
// (4,2048,16384,16) it reads dt and x (1.07 GB) and writes y (0.54 GB):
// 0.48 ms at 3.35 TB/s. It also takes B T D N = 2.1 G exponentials, 0.51 ms
// on the special-function units (16 a clock per SM at 1.98 GHz): the two
// limits meet, so the design keeps both streams busy at once and spends as
// few other instructions as it can per exponential.
//
// Design. One thread owns one (b, d) channel and keeps its N states h[n]
// in registers, beside the N decay rates A[d, n] log2(e), loaded once; a
// block holds CH = 32 WARPS adjacent channels of one batch row, and the
// grid covers (channel blocks, B). Per step a thread reads its dt_t[d] and
// x_t[d], and every thread of the block reads the same B_t[0..N) and
// C_t[0..N) from shared memory (a broadcast, four values a load), then
//   a = 2^(dt A[d, n] log2 e),  h[n] = a h[n] + (dt B_t[n]) x_t,
// and y_t = sum_n h[n] C_t[n] summed in registers from n = 0 up: no
// shuffle, and a fixed order, so two launches are bitwise equal. The
// exponent is <= 0 (dt = softplus > 0, A = -exp(a_log) < 0), so the
// exponential is one MUFU.EX2 (ex2.approx.ftz: a relative error near 2^-22;
// a decay below 2^-126 flushes to 0, against the plain version's subnormal
// of under 1.2e-38).
//
// Loads overlap the compute: the time axis is cut into tiles of TT steps,
// and each tile's dt and x rows (CH channels) and its B and C rows go
// through a ring of STAGES shared-memory slots filled by cp.async (16 bytes
// a copy where the strides allow it, 4 bytes otherwise) STAGES - 1 tiles
// ahead of the step loop. Each thread writes its y_t in place of the x_t it
// has read; after the tile each warp writes its own 32 columns of y out in
// coalesced rows (16-byte stores when D is a multiple of 4). One block
// barrier per tile frees the slot of the previous tile for its refill.
// Ragged T and D are zero-filled in the loads and masked in the stores.
// The block (WARPS, STAGES, TT) was chosen by timing a few on the card
// (PERF.md, section 6).

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;    // warps per block: CH = 32 WARPS channels
constexpr int STAGES = 3;   // shared-memory slots in the cp.async ring
constexpr int TT = 16;      // time steps per tile
constexpr int CH = 32 * WARPS;
constexpr int THREADS = CH;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(STAGES >= 2, "the ring needs two slots");

// element strides: dt b/t, x b/t, Bt b/t, Ct b/t
struct Strides {
  long long s[8];
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// floats of one ring slot: dt and x rows (TT x CH), then B and C rows (TT x N)
template <int N>
__host__ __device__ constexpr int slot_floats() {
  return TT * (2 * CH + 2 * N);
}

// Issues the copies of tile `k` (steps k TT ..) into `slot`, zero-filling
// steps past T and channels past D. VEC: 16-byte copies (every base and
// stride a multiple of 4 floats), else 4-byte ones.
template <int N, bool VEC>
__device__ __forceinline__ void load_tile(float* slot, int k, int T, int D,
                                          int d0, const float* dtb,
                                          const float* xb, const float* Bb,
                                          const float* Cb,
                                          const long long* st) {
  float* s_dt = slot;
  float* s_x = slot + TT * CH;
  float* s_b = slot + 2 * TT * CH;
  float* s_c = s_b + TT * N;
  const int t0 = k * TT;
  constexpr int V = VEC ? 4 : 1;
  for (int i = threadIdx.x; i < TT * CH / V; i += THREADS) {
    const int r = i / (CH / V);
    const int c = (i % (CH / V)) * V;
    const int t = t0 + r;
    const int left = (t < T) ? D - (d0 + c) : 0;
    const int bytes = 4 * max(0, min(V, left));
    const long long tb = static_cast<long long>(bytes ? t : 0);
    const int dd = bytes ? d0 + c : 0;
    if (VEC) {
      cp_async16(s_dt + r * CH + c, dtb + tb * st[1] + dd, bytes);
      cp_async16(s_x + r * CH + c, xb + tb * st[3] + dd, bytes);
    } else {
      cp_async4(s_dt + r * CH + c, dtb + tb * st[1] + dd, bytes);
      cp_async4(s_x + r * CH + c, xb + tb * st[3] + dd, bytes);
    }
  }
  for (int i = threadIdx.x; i < TT * N / V; i += THREADS) {
    const int r = i / (N / V);
    const int c = (i % (N / V)) * V;
    const int t = t0 + r;
    const int bytes = (t < T) ? 4 * V : 0;
    const long long tb = static_cast<long long>(bytes ? t : 0);
    if (VEC) {
      cp_async16(s_b + r * N + c, Bb + tb * st[5] + c, bytes);
      cp_async16(s_c + r * N + c, Cb + tb * st[7] + c, bytes);
    } else {
      cp_async4(s_b + r * N + c, Bb + tb * st[5] + c, bytes);
      cp_async4(s_c + r * N + c, Cb + tb * st[7] + c, bytes);
    }
  }
}

template <int N, bool VEC>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ x, float* __restrict__ y,
                  float* __restrict__ h_end, int T, int D, bool y_vec,
                  const Strides sd) {
  static_assert(N % 4 == 0, "B and C rows are read four at a time");
  extern __shared__ __align__(16) float ring[];
  const long long* st = sd.s;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int d = d0 + tid;
  const bool live = d < D;

  const float* dtb = dt + b * st[0];
  const float* xb = x + b * st[2];
  const float* Bb = Bm + b * st[4];
  const float* Cb = Cm + b * st[6];
  float* yb = y + static_cast<long long>(b) * T * D;

  float al[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    al[n] = live ? A[static_cast<long long>(d) * N + n] * kLog2e : 0.f;
    h[n] = 0.f;
  }

  const int tiles = (T + TT - 1) / TT;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < tiles)
      load_tile<N, VEC>(ring + k * slot_floats<N>(), k, T, D, d0, dtb, xb, Bb,
                        Cb, st);
    cp_async_commit();
  }

  for (int k = 0; k < tiles; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile k is in; every warp is done with tile k - 1
    const int next = k + STAGES - 1;
    if (next < tiles)
      load_tile<N, VEC>(ring + (next % STAGES) * slot_floats<N>(), next, T, D,
                        d0, dtb, xb, Bb, Cb, st);
    cp_async_commit();

    float* slot = ring + (k % STAGES) * slot_floats<N>();
    const float* s_dt = slot;
    float* s_x = slot + TT * CH;
    const float4* s_b = reinterpret_cast<const float4*>(slot + 2 * TT * CH);
    const float4* s_c = s_b + TT * N / 4;
    const int L = min(TT, T - k * TT);
#pragma unroll 2
    for (int r = 0; r < L; ++r) {
      const float dtv = s_dt[r * CH + tid];
      const float xv = s_x[r * CH + tid];
      float yv = 0.f;
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 b4 = s_b[r * (N / 4) + q];
        const float4 c4 = s_c[r * (N / 4) + q];
        const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * q + e;
          const float a = ex2(dtv * al[n]);
          h[n] = __fmaf_rn(a, h[n], (dtv * bq[e]) * xv);
          yv = (n == 0) ? h[n] * cq[e] : __fmaf_rn(h[n], cq[e], yv);
        }
      }
      s_x[r * CH + tid] = yv;  // y_t in place of x_t
    }
    __syncwarp();

    // this warp's 32 columns of y, rows t0 .. t0 + L
    const int t0 = k * TT;
    const int c0 = warp * 32;
    if (y_vec) {
      for (int i = lane; i < L * 8; i += 32) {
        const int r = i / 8;
        const int c = c0 + (i % 8) * 4;
        if (d0 + c < D)
          *reinterpret_cast<float4*>(yb + static_cast<long long>(t0 + r) * D +
                                     d0 + c) =
              *reinterpret_cast<const float4*>(s_x + r * CH + c);
      }
    } else if (live) {
      for (int r = 0; r < L; ++r)
        yb[static_cast<long long>(t0 + r) * D + d] = s_x[r * CH + tid];
    }
  }
  cp_async_wait<0>();

  if (live) {
    float* ho = h_end + (static_cast<long long>(b) * D + d) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) ho[n] = h[n];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

template <int N, bool VEC>
int launch_body(const float* dt, const float* A, const float* Bm,
                const float* Cm, const float* x, float* y, float* h_end, int B,
                int T, int D, const Strides& sd, cudaStream_t stream) {
  const size_t smem = sizeof(float) * STAGES * slot_floats<N>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mamba_scan_kernel<N, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((D + CH - 1) / CH, B);
  const bool y_vec = D % 4 == 0 && aligned16(y);
  mamba_scan_kernel<N, VEC><<<grid, THREADS, smem, stream>>>(
      dt, A, Bm, Cm, x, y, h_end, T, D, y_vec, sd);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch(const float* dt, const float* A, const float* Bm, const float* Cm,
           const float* x, float* y, float* h_end, int B, int T, int D,
           const long long* st, cudaStream_t stream) {
  Strides sd;
  bool vec = aligned16(dt) && aligned16(x) && aligned16(Bm) && aligned16(Cm);
  for (int i = 0; i < 8; ++i) {
    sd.s[i] = st[i];
    vec = vec && st[i] % 4 == 0;
  }
  return vec ? launch_body<N, true>(dt, A, Bm, Cm, x, y, h_end, B, T, D, sd,
                                    stream)
             : launch_body<N, false>(dt, A, Bm, Cm, x, y, h_end, B, T, D, sd,
                                     stream);
}

}  // namespace

extern "C" {

// strides (elements): dt b/t, x b/t, Bt b/t, Ct b/t; every last dimension
// and A contiguous, y and h_end written contiguous. N in {8, 16}.
// Returns a cudaError_t.
int mamba_scan_fwd(const void* dt, const void* A, const void* Bt,
                   const void* Ct, const void* x, void* y, void* h_end, int B,
                   int T, int D, int N, const long long* strides,
                   void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in[5] = {static_cast<const float*>(dt),
                        static_cast<const float*>(A),
                        static_cast<const float*>(Bt),
                        static_cast<const float*>(Ct),
                        static_cast<const float*>(x)};
  float* yo = static_cast<float*>(y);
  float* ho = static_cast<float*>(h_end);
  if (N == 16)
    return launch<16>(in[0], in[1], in[2], in[3], in[4], yo, ho, B, T, D,
                      strides, s);
  if (N == 8)
    return launch<8>(in[0], in[1], in[2], in[3], in[4], yo, ho, B, T, D,
                     strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mamba_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
