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
// at the SFU's 16 a clock per SM, about as long: both limits meet.
//
// Design. The TPU kernel walked the time chunks of one (b, channel block)
// in order on its sequential grid axis, h in VMEM. Here every (b, d, n)
// recurrence is one thread that loops over t, h in a register: a block of
// 256 threads holds 256 / N channels (16 lanes per channel for N = 16, 8 for
// N = 8), and the grid covers (channel blocks, B), 4,096 blocks at the
// jamba shape. Per time tile of TT steps the block stages dt and x (rows of
// 256 / N adjacent channels, coalesced) and Bt, Ct (shared by every channel)
// in shared memory, then steps through the tile; y_t[d] is summed over the
// N lanes of a channel by an xor butterfly of warp shuffles whose result is
// taken from lane 0, a fixed order, so two launches are bitwise equal. The
// tile's y goes to shared memory and out in coalesced rows. Ragged T and D
// are masked in the loads and stores; dt A <= 0 always (dt = softplus > 0,
// A = -exp(a_log) < 0), so no exponential overflows. expf, not __expf:
// built without fast math.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TT = 64;  // time steps staged per tile

// element strides: dt b/t, x b/t, Bt b/t, Ct b/t
struct Strides {
  long long s[8];
};

template <int N>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ x, float* __restrict__ y,
                  float* __restrict__ h_end, int T, int D, const Strides sd) {
  constexpr int CH = THREADS / N;  // channels per block
  __shared__ float dts[TT][CH];
  __shared__ float xs[TT][CH];
  __shared__ float ys[TT][CH];
  __shared__ float bs[TT][N];
  __shared__ float cs[TT][N];

  const long long* st = sd.s;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int c = tid / N;
  const int n = tid % N;
  const int d = d0 + c;
  const bool live = d < D;

  const float* dtb = dt + b * st[0];
  const float* xb = x + b * st[2];
  const float* Bb = Bm + b * st[4];
  const float* Cb = Cm + b * st[6];
  float* yb = y + static_cast<long long>(b) * T * D;

  const float a_dn = live ? A[static_cast<long long>(d) * N + n] : 0.f;
  float h = 0.f;

  for (int t0 = 0; t0 < T; t0 += TT) {
    const int L = min(TT, T - t0);
    __syncthreads();  // the previous tile's reads and y stores are done
    for (int i = tid; i < TT * CH; i += THREADS) {
      const int t = i / CH, cc = i % CH;
      const bool ok = t < L && d0 + cc < D;
      dts[t][cc] = ok ? dtb[(t0 + t) * st[1] + d0 + cc] : 0.f;
      xs[t][cc] = ok ? xb[(t0 + t) * st[3] + d0 + cc] : 0.f;
    }
    for (int i = tid; i < TT * N; i += THREADS) {
      const int t = i / N, nn = i % N;
      const bool ok = t < L;
      bs[t][nn] = ok ? Bb[(t0 + t) * st[5] + nn] : 0.f;
      cs[t][nn] = ok ? Cb[(t0 + t) * st[7] + nn] : 0.f;
    }
    __syncthreads();

    for (int t = 0; t < L; ++t) {
      const float dtv = dts[t][c];
      const float a = expf(dtv * a_dn);
      h = a * h + (dtv * bs[t][n]) * xs[t][c];
      float p = h * cs[t][n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off, N);
      if (n == 0) ys[t][c] = p;
    }
    __syncthreads();

    for (int i = tid; i < L * CH; i += THREADS) {
      const int t = i / CH, cc = i % CH;
      if (d0 + cc < D)
        yb[static_cast<long long>(t0 + t) * D + d0 + cc] = ys[t][cc];
    }
  }
  if (live) h_end[(static_cast<long long>(b) * D + d) * N + n] = h;
}

template <int N>
int launch(const float* dt, const float* A, const float* Bm, const float* Cm,
           const float* x, float* y, float* h_end, int B, int T, int D,
           const long long* st, cudaStream_t stream) {
  constexpr int CH = THREADS / N;
  Strides sd;
  for (int i = 0; i < 8; ++i) sd.s[i] = st[i];
  const dim3 grid((D + CH - 1) / CH, B);
  mamba_scan_kernel<N><<<grid, THREADS, 0, stream>>>(dt, A, Bm, Cm, x, y,
                                                     h_end, T, D, sd);
  return static_cast<int>(cudaGetLastError());
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
