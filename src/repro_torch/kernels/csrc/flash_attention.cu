// flash_attention.cu — causal / sliding-window GQA attention on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel). Its plain PyTorch twin is
// repro_torch/kernels/flash_attention.py::flash_attention_ref.
//
// What it computes, for every batch b, query head h and query position s:
//   o[b,h,s] = softmax_t(scale * q[b,h,s] . k[b,h/G,t]) v[b,h/G,t]
// over the keys t the mask lets through: t < T always, t <= s when causal,
// t > s - window when a window is set. q (B,H,S,hd), k (B,KV,T,hd),
// v (B,KV,T,vd) in float32, bfloat16 or float16, read through their strides
// (the last dimension contiguous); o (B,H,S,vd) contiguous, in q's type.
//
// What bounds it: operations. At the serving prefill shape
// (B,H,S,hd) = (4,48,2048,128) causal, QK^T and PV are ~2 x 103 G MAC,
// against ~235 MB of q/k/v/o.
//
// Design. One block per (query tile of 64 rows, h, b), the query tiles of a
// head walked from the last (most keys under the causal mask) to the first.
// The block loops over 64-key tiles from the window's first key (or 0) to
// the causal diagonal (or T), with the q, k and v tiles in shared memory.
// Two bodies:
//  * bf16 / f16 (the serving path): 4 warps on the tensor cores through
//    mma.sync.m16n8k16 with float32 accumulation, 16 query rows per warp;
//    the score fragments are reused as the A fragments of P V, so P is
//    rounded to the input type before that product (the TPU body kept P in
//    float32; the gap is inside the bf16 tolerance). It needs hd % 16 == 0
//    and an even vd <= 128; other 16-bit shapes are refused
//    (cudaErrorInvalidValue). No TMA / wgmma pipeline yet: later work.
//  * float32: 256 threads of float32 FMAs, each owning a 4 x 4 block of
//    the score tile and the same 4 output rows; any hd, vd <= 256.
// In both, the running max m, sum l and the rescale by
// alpha = exp(m_prev - m_cur) stay in float32 registers (as the TPU body's
// m/l/acc scratch). Masked scores are -1e30, not
// -inf: a tile in which a row sees no key gives alpha = 1 and p = 1 for that
// row, which the first tile with a visible key wipes (alpha = 0), exactly as
// the TPU body; l is clamped at 1e-30 before the division. Ragged S and T
// are zero-padded in shared memory and padded keys are masked whether or not
// the mask is causal. No atomics: each block writes its own rows, so two
// launches give bitwise equal outputs. Built without fast math.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int LDT = BQ + 4;   // padded row of the transposed tiles
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

// reduce over the 16 lanes that share a row (lanes 0-15 or 16-31 of a warp)
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// float32 body. VPT output columns per thread: vd <= 16 * VPT
template <int VPT>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int KV,
                 int S, int Tk, int hd, int vd, long long qsb, long long qsh,
                 long long qss, long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss, float scale,
                 int causal, int window) {
  constexpr int VD = 16 * VPT;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                                  // [hd][LDT]
  float* KPs = Qs + hd * LDT;                        // [max(hd,BK)][LDT]
  float* Vs = KPs + (hd > BK ? hd : BK) * LDT;       // [BK][VD]

  const int n_q = (S + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, d = i % hd, s = q0 + r;
    Qs[d * LDT + r] = s < S ? qb[s * qss + d] : 0.f;
  }

  float m[4], l[4], acc[4][VPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < VPT; ++c) acc[i][c] = 0.f;
  }

  int kv_end = Tk;
  if (causal && q0 + BQ < kv_end) kv_end = q0 + BQ;
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kv_begin = q0 - window + 1;
  kv_begin = (kv_begin / BK) * BK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's P and V reads are done
    for (int i = tid; i < BK * hd; i += THREADS) {
      const int r = i / hd, d = i % hd, t = k0 + r;
      KPs[d * LDT + r] = t < Tk ? kb[t * kss + d] : 0.f;
    }
    for (int i = tid; i < BK * VD; i += THREADS) {
      const int r = i / VD, c = i % VD, t = k0 + r;
      Vs[r * VD + c] = (t < Tk && c < vd) ? vb[t * vss + c] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * LDT + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&KPs[d * LDT + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], cv[j], sc[i][j]);
    }
    __syncthreads();  // every K read is done: the K tile becomes P

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        bool ok = kpos < Tk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        sc[i][j] = ok ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_cur = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_cur);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_cur);
        ps += p;
        KPs[(tx * 4 + j) * LDT + ty * 4 + i] = p;
      }
      l[i] = l[i] * alpha + row_sum(ps);
#pragma unroll
      for (int c = 0; c < VPT; ++c) acc[i][c] *= alpha;
      m[i] = m_cur;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(&KPs[j * LDT + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[VPT];
#pragma unroll
      for (int c = 0; c < VPT; ++c) vv[c] = Vs[j * VD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < VPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    float* orow = o + ((static_cast<long long>(b) * H + h) * S + s) * vd;
#pragma unroll
    for (int c = 0; c < VPT; ++c) {
      const int col = tx + 16 * c;
      if (col < vd) orow[col] = acc[i][c] / lc;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores through mma.sync.m16n8k16 (float32 accumulate)
// ---------------------------------------------------------------------------

constexpr int MTHREADS = 128;  // 4 warps, 16 query rows each

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ __nv_bfloat16 zero_of() {
  return __float2bfloat16(0.f);
}
template <> __device__ __forceinline__ __half zero_of() {
  return __float2half(0.f);
}

// two consecutive 16-bit elements as one 32-bit fragment register
template <typename T>
__device__ __forceinline__ uint32_t ld_pair(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
template <typename T>
__device__ __forceinline__ uint32_t pack_rows(const T* lo, const T* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}
template <typename T> __device__ __forceinline__ uint32_t pack_f(float a,
                                                                 float b);
template <> __device__ __forceinline__ uint32_t pack_f<__nv_bfloat16>(
    float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t pack_f<__half>(float a,
                                                               float b) {
  __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 16 bytes global -> shared without a register round trip; src_size 0
// zero-fills (a row past S or T)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// rows [r0, r0 + rows) of a (len, width) global slab with row stride `ld_g`
// into shared rows of stride `ld_s`, columns >= width (up to width_s) and
// rows >= len zero-filled. VEC: 16-byte cp.async chunks (every row start
// and width 16-byte aligned), else element by element.
template <typename T, bool VEC>
__device__ __forceinline__ void load_tile(T* dst, int ld_s, const T* src,
                                          long long ld_g, int r0, int rows,
                                          int len, int width, int width_s,
                                          int tid, int nthreads) {
  if constexpr (VEC) {
    const int cw = width_s / 8;
    for (int i = tid; i < rows * cw; i += nthreads) {
      const int r = i / cw, c = (i % cw) * 8, gr = r0 + r;
      const bool ok = gr < len && c < width;
      cp_async16(&dst[r * ld_s + c], ok ? src + gr * ld_g + c : src, ok);
    }
    cp_async_wait_all();
  } else {
    const T zero = zero_of<T>();
    for (int i = tid; i < rows * width_s; i += nthreads) {
      const int r = i / width_s, c = i % width_s, gr = r0 + r;
      dst[r * ld_s + c] = (gr < len && c < width) ? src[gr * ld_g + c] : zero;
    }
  }
}

// c += a (16x16, row) * b (16x8, col), float32 accumulators
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]);
template <> __device__ __forceinline__ void mma<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <> __device__ __forceinline__ void mma<__half>(
    float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One block of 4 warps per (64-row query tile, h, b); warp w owns rows
// 16w..16w+15. Per 64-key tile: S = Q K^T as 8 m16n8 fragments per warp
// (hd in steps of 16), the online softmax on the fragments' rows (a quad
// of 4 lanes shares two rows), then P, rounded to T, times V from the same
// registers (the S fragments are P's A fragments). m, l and the output
// (VN n-tiles of 8 columns) stay in float32 registers. hd % 16 == 0,
// vd <= 8 * VN, vd % 2 == 0.
template <typename T, int VN, bool VEC>
__global__ void __launch_bounds__(MTHREADS)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                 int S, int Tk, int hd, int vd, long long qsb, long long qsh,
                 long long qss, long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss, float scale,
                 int causal, int window) {
  constexpr int VD = 8 * VN;
  constexpr int LDV = VD + 8;  // padded rows: conflict-free fragment loads
  const int LDQ = hd + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LDQ]
  T* Ks = Qs + BQ * LDQ;                   // [BK][LDQ]
  T* Vs = Ks + BK * LDQ;                   // [BK][LDV]

  const int n_q = (S + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (and B column) within the tile
  const int t = lane % 4;  // fragment column pair
  const int row0 = (tid / 32) * 16 + g;  // this lane's rows: row0, row0 + 8

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  load_tile<T, VEC>(Qs, LDQ, qb, qss, q0, BQ, S, hd, hd, tid, MTHREADS);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[VN][4];
#pragma unroll
  for (int n = 0; n < VN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int kv_end = Tk;
  if (causal && q0 + BQ < kv_end) kv_end = q0 + BQ;
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kv_begin = q0 - window + 1;
  kv_begin = (kv_begin / BK) * BK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's K and V reads are done
    load_tile<T, VEC>(Ks, LDQ, kb, kss, k0, BK, Tk, hd, hd, tid, MTHREADS);
    load_tile<T, VEC>(Vs, LDV, vb, vss, k0, BK, Tk, vd, VD, tid, MTHREADS);
    __syncthreads();

    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    for (int kk = 0; kk < hd; kk += 16) {
      const uint32_t a[4] = {ld_pair(&Qs[row0 * LDQ + kk + t * 2]),
                             ld_pair(&Qs[(row0 + 8) * LDQ + kk + t * 2]),
                             ld_pair(&Qs[row0 * LDQ + kk + 8 + t * 2]),
                             ld_pair(&Qs[(row0 + 8) * LDQ + kk + 8 + t * 2])};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const T* kr = &Ks[(j * 8 + g) * LDQ + kk + t * 2];
        const uint32_t bf[2] = {ld_pair(kr), ld_pair(kr + 8)};
        mma<T>(sc[j], a, bf);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + row0 + 8 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + j * 8 + t * 2 + e;
          bool ok = kpos < Tk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          const float x = ok ? sc[j][2 * r + e] * scale : NEG_INF;
          sc[j][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_cur = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_cur);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(sc[j][2 * r + e] - m_cur);
          sc[j][2 * r + e] = p;
          ps += p;
        }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[r] = l[r] * alpha + ps;
      m[r] = m_cur;
#pragma unroll
      for (int n = 0; n < VN; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_f<T>(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_f<T>(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_f<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_f<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const T* vr = &Vs[(kk * 16 + t * 2) * LDV + g];
#pragma unroll
      for (int n = 0; n < VN; ++n) {
        const uint32_t bf[2] = {
            pack_rows(vr + n * 8, vr + LDV + n * 8),
            pack_rows(vr + 8 * LDV + n * 8, vr + 9 * LDV + n * 8)};
        mma<T>(acc[n], a, bf);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + row0 + 8 * r;
    if (s >= S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * H + h) * S + s) * vd;
#pragma unroll
    for (int n = 0; n < VN; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + t * 2 + e;
        if (col < vd) orow[col] = from_f<T>(acc[n][2 * r + e] / lc);
      }
  }
}

template <typename T, int VN>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KV, int S, int Tk, int hd, int vd,
               const long long* st, float scale, int causal, int window,
               cudaStream_t stream) {
  const size_t smem = sizeof(T) * (static_cast<size_t>(BQ + BK) * (hd + 8) +
                                   static_cast<size_t>(BK) * (8 * VN + 8));
  // 16-byte copies need every row start 16-byte aligned
  bool vec = hd % 8 == 0 && vd % 8 == 0 &&
             (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
              reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
  auto kern = vec ? flash_mma_kernel<T, VN, true>
                  : flash_mma_kernel<T, VN, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, MTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, S, Tk, hd, vd,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int VPT>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KV, int S, int Tk, int hd, int vd,
               const long long* st, float scale, int causal, int window,
               cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(hd) * LDT +
                       static_cast<size_t>(hd > BK ? hd : BK) * LDT +
                       static_cast<size_t>(BK) * 16 * VPT);
  auto kern = flash_fwd_kernel<VPT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KV, S, Tk, hd,
      vd,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int KV, int S, int Tk, int hd, int vd,
                 const long long* st, float scale, int causal, int window,
                 cudaStream_t s) {
  if (vd <= 32)
    return launch_f32<2>(q, k, v, o, B, H, KV, S, Tk, hd, vd, st, scale,
                         causal, window, s);
  if (vd <= 64)
    return launch_f32<4>(q, k, v, o, B, H, KV, S, Tk, hd, vd, st, scale,
                         causal, window, s);
  if (vd <= 128)
    return launch_f32<8>(q, k, v, o, B, H, KV, S, Tk, hd, vd, st, scale,
                         causal, window, s);
  return launch_f32<16>(q, k, v, o, B, H, KV, S, Tk, hd, vd, st, scale,
                        causal, window, s);
}

// 16-bit inputs: the tensor-core body only (hd % 16 == 0, even vd <= 128)
template <typename T>
int dispatch_mma(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int KV, int S, int Tk, int hd, int vd,
                 const long long* st, float scale, int causal, int window,
                 cudaStream_t s) {
  if (hd % 16 != 0 || vd % 2 != 0 || vd > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vd <= 32)
    return launch_mma<T, 4>(q, k, v, o, B, H, KV, S, Tk, hd, vd, st, scale,
                            causal, window, s);
  if (vd <= 64)
    return launch_mma<T, 8>(q, k, v, o, B, H, KV, S, Tk, hd, vd, st, scale,
                            causal, window, s);
  return launch_mma<T, 16>(q, k, v, o, B, H, KV, S, Tk, hd, vd, st, scale,
                           causal, window, s);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 float16. strides (elements): q b/h/s,
// k b/h/t, v b/h/t. window <= 0: no window. Returns a cudaError_t.
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, int B, int H, int KV, int S,
                        int T, int hd, int vd, long long qsb, long long qsh,
                        long long qss, long long ksb, long long ksh,
                        long long kss, long long vsb, long long vsh,
                        long long vss, float scale, int causal, int window,
                        void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || T <= 0 ||
      hd <= 0 || hd > 256 || vd <= 0 || vd > 256 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_f32(q, k, v, o, B, H, KV, S, T, hd, vd, st, scale,
                          causal, window, s);
    case 1:
      return dispatch_mma<__nv_bfloat16>(q, k, v, o, B, H, KV, S, T, hd, vd,
                                         st, scale, causal, window, s);
    case 2:
      return dispatch_mma<__half>(q, k, v, o, B, H, KV, S, T, hd, vd, st,
                                  scale, causal, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
