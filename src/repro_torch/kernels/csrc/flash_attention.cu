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
// Three bodies; the Python wrapper picks one (flash_attention.py::body) and
// calls its entry, which refuses any shape it does not take:
//  * wgmma (flash_attention_fwd_wgmma; bf16 / f16, hd == vd in {64, 128}
//    or MLA's q/k 96 with v 64, every stride a multiple of 16 bytes and
//    every base 16-byte aligned):
//    one persistent block per SM takes (128-row query tile, h, b) tiles
//    from a global counter, head by head and each head's longest first (so
//    the blocks at work share a few heads' K/V in L2); a producer
//    warpgroup and two
//    consumer warpgroups of 64 rows. The producer's one thread loads each
//    tile's Q by TMA and keeps a ring of K/V stages in flight (128-key
//    tiles, 128-byte swizzle, an mbarrier full/empty pair per stage),
//    running on into the next tile while the consumers finish this one, the
//    tensor maps encoded on the host per call from the tensors' strides;
//    `setmaxnreg` hands its registers to the consumers. Each consumer runs
//    S = Q K^T as wgmma with both operands in shared memory, the online
//    softmax on the accumulator fragments in float32 (exp2 with
//    scale * log2(e) folded in), P rounded to the input type in registers,
//    and O += P V as wgmma with P as the register A operand and V as the
//    transposed shared-memory B operand. The softmax of tile i runs while
//    the P V product of tile i - 1 is in flight, and the two consumers take
//    turns starting their products (named barriers), so one's softmax
//    overlaps the other's tensor-core work. Only the tiles that cross the
//    causal diagonal, the window's edge or T are masked.
//  * mma.sync (flash_attention_fwd, 16-bit; hd % 16 == 0, an even vd <= 128):
//    one block of 4 warps per (64-row query tile, h, b) on
//    mma.sync.m16n8k16 with float32 accumulation, 16 query rows per warp,
//    16-byte cp.async tile loads; every other 16-bit shape (hd 32,
//    hd == vd == 96, other vd != hd, strides or bases off 16 bytes).
//  * float32 (flash_attention_fwd, float32): 256 threads of float32 FMAs,
//    each owning a 4 x 4 block of the score tile and the same 4 output
//    rows; any hd, vd <= 256.
// The query tiles are walked from the last (most keys under the causal
// mask) to the first. The 16-bit bodies reuse the score fragments as the A
// fragments of P V, so P is rounded to the input type before that product
// (the TPU body kept P in float32; the gap is inside the bf16 tolerance).
// In all three, the running max m, sum l and the rescale by
// alpha = exp(m_prev - m_cur) stay in float32 registers (as the TPU body's
// m/l/acc scratch). Masked scores are -1e30, not
// -inf: a tile in which a row sees no key gives alpha = 1 and p = 1 for that
// row, which the first tile with a visible key wipes (alpha = 0), exactly as
// the TPU body; l is clamped at 1e-30 before the division. Ragged S and T
// are zero-padded in shared memory (by TMA in the wgmma body) and padded
// keys are masked whether or not the mask is causal. No atomics and no
// split over keys: each block writes its own rows, so two launches give
// bitwise equal outputs. Built without fast math.

#include <cuda.h>
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

// ---------------------------------------------------------------------------
// bf16 / f16 with hd == vd in {64, 128} or (hd, vd) = (96, 64): wgmma fed
// by a TMA ring, warp-specialised (a producer warpgroup, two consumer
// warpgroups)
// ---------------------------------------------------------------------------

constexpr int WG_BQ = 128;       // query rows per block: two consumers of 64
constexpr int WG_BK = 128;       // keys per K/V stage
constexpr int WG_THREADS = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// arrive once and add `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one TMA box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing its bytes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (in 16-byte units), layout 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// named barrier `id` over the two consumer warpgroups (256 threads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
// keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[i][e])::"memory");
}

// D (64 x N, float32) (+)= A (64 x 16) B (16 x N), both K-major in shared
// memory; accumulate 0 overwrites D
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate);
// D (64 x N, float32) += A (64 x 16, registers) B (16 x N, N-major in shared
// memory)
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <> __device__ __forceinline__ void wgmma_ss<__nv_bfloat16, 64>(
    float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <> __device__ __forceinline__ void wgmma_ss<__nv_bfloat16, 128>(
    float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <> __device__ __forceinline__ void wgmma_ss<__half, 64>(
    float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <> __device__ __forceinline__ void wgmma_ss<__half, 128>(
    float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <> __device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <> __device__ __forceinline__ void wgmma_rs<__nv_bfloat16, 128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <> __device__ __forceinline__ void wgmma_rs<__half, 64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <> __device__ __forceinline__ void wgmma_rs<__half, 128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// This consumer's rows and the mask: rows r0 .. r0 + 63, this lane's
// rows row0 and row0 + 8, its accumulator columns 2 t, 2 t + 1 of every 8
struct Rows {
  int r0, row0, t, Tk, causal, window;
  float scale_log2;
};

// S = Q K^T (64 x WG_BK, float32) for this consumer's 64 rows of the Q
// tile at `qa` and the K tile at `kb`: HD / 16 steps of 16 along the head
// dimension, 32 bytes into a 128-byte swizzled row per step, a new 64-column
// slab every 4 (at HD 96 the second slab's columns 96-127, zero-filled by
// TMA, are never read); the first step overwrites sc. Started and
// committed; the caller waits.
template <typename T, int HD>
__device__ __forceinline__ void qk_start(float (&sc)[WG_BK / 2], uint32_t qa,
                                         uint32_t kb) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<T, WG_BK>(
        sc, sw128_desc(qa + (kk / 4) * (WG_BQ * 128) + off, 16, 1024),
        sw128_desc(kb + (kk / 4) * (WG_BK * 128) + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// 2^x on the special-function unit (2 ulp; results below 2^-126 flush to
// 0, where p is negligible beside the row's largest term, 1)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of the tile of keys k0 .. k0 + WG_BK in log2 units
// (x = s * scale * log2(e)): m and l move to this tile, sc becomes P in
// float32 and alpha = exp2(m_prev - m). A tile that crosses the causal
// diagonal, the window's edge or T masks its scores to -1e30; a full tile
// with a positive scale takes the row max of the raw scores and one FFMA
// per score, p = exp2(s * scale * log2(e) - m).
template <int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], int k0,
                                             const Rows& w, float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2]) {
  const bool edge = k0 + WG_BK > w.Tk ||
                    (w.causal && k0 + WG_BK - 1 > w.r0) ||
                    (w.window > 0 && k0 <= w.r0 + 63 - w.window);
  const bool fast = !edge && w.scale_log2 > 0.f;
  float mx[2] = {NEG_INF, NEG_INF};
  if (fast) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] *= w.scale_log2;
  } else {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = w.row0 + 8 * (e >> 1);
        const int kpos = k0 + 8 * j + 2 * w.t + (e & 1);
        bool ok = kpos < w.Tk;
        if (w.causal) ok = ok && kpos <= qpos;
        if (w.window > 0) ok = ok && kpos > qpos - w.window;
        const float x = ok ? sc[4 * j + e] * w.scale_log2 : NEG_INF;
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_cur = fmaxf(m[r], mx[r]);
    alpha[r] = ex2_ftz(m[r] - m_cur);
    m[r] = m_cur;
  }
  if (fast) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float p = ex2_ftz(fmaf(sc[j], w.scale_log2, -m[(j >> 1) & 1]));
      sc[j] = p;
      ps[(j >> 1) & 1] += p;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float p = ex2_ftz(sc[j] - m[(j >> 1) & 1]);
      sc[j] = p;
      ps[(j >> 1) & 1] += p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
    ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
    l[r] = l[r] * alpha[r] + ps[r];
  }
}

// O's rows to the new running max
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] *= alpha[(j >> 1) & 1];
}

// P, rounded to T, as wgmma's register A fragments: keys 16 kk .. 16 kk +
// 15 are the accumulator's column tiles 2 kk and 2 kk + 1
template <typename T>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[WG_BK / 16][4],
                                       const float (&sc)[WG_BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < WG_BK / 16; ++kk) {
    pa[kk][0] = pack_f<T>(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_f<T>(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_f<T>(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_f<T>(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// O += P V for the V tile at `vb`: its rows are keys with the value columns
// contiguous (the N-major B operand): 8-key groups 1024 bytes apart,
// 64-column slabs WG_BK * 128 bytes apart, 16 keys (2048 bytes) per step.
// Started and committed; the caller waits.
template <typename T, int VD>
__device__ __forceinline__ void pv_start(float (&acc)[VD / 2],
                                         uint32_t (&pa)[WG_BK / 16][4],
                                         uint32_t vb) {
  fence_regs(acc);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < WG_BK / 16; ++kk)
    wgmma_rs<T, VD>(acc, pa[kk], sw128_desc(vb + kk * 2048, WG_BK * 128, 1024));
  wgmma_commit();
}
// one arrival per consumer warp on a stage's empty barrier
__device__ __forceinline__ void release_stage(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// A (128-row query tile, h, b) of the grid, numbered head by head ((b, h)
// in order; GQA's heads of one K/V head are neighbours) and within a head
// last (most keys) first: its rows q0 .. q0 + 127 and its 128-key steps
// from kv_begin (the window's first key, or 0) to the causal diagonal (or
// T). The blocks at work hold the tiles of a few heads, whose K/V stay in
// L2 while they are read again: numbered query tile first over all heads,
// MLA's 160 heads of K/V (105 MB at 4 x 2048) were read from HBM for each
// of their 16 query tiles, and its body ran at 0.36 ms instead of 0.29.
struct Tile {
  int q0, h, b, kv_begin, n_steps;
};

__device__ __forceinline__ Tile tile_of(int w, int B, int H, int S, int Tk,
                                        int causal, int window) {
  Tile x;
  const int n_q = (S + WG_BQ - 1) / WG_BQ;
  const int bh = w / n_q;
  x.q0 = (n_q - 1 - w % n_q) * WG_BQ;
  x.h = bh % H;
  x.b = bh / H;
  int kv_end = Tk;
  if (causal && x.q0 + WG_BQ < kv_end) kv_end = x.q0 + WG_BQ;
  int kv_begin = 0;
  if (window > 0 && x.q0 - window + 1 > 0) kv_begin = x.q0 - window + 1;
  x.kv_begin = (kv_begin / WG_BK) * WG_BK;
  x.n_steps = kv_end > x.kv_begin
                  ? (kv_end - x.kv_begin + WG_BK - 1) / WG_BK
                  : 0;
  return x;
}

// Persistent: one block per SM. Warpgroup 0's first thread takes the tiles
// one after another (its block's index first, then the next from the
// global counter `next`, in `tile_of`'s order, to whichever block is
// free), writes each tile's index to shared memory, loads its Q
// (ceil(HD / 64) swizzled 64-column slabs) by TMA, and keeps the K tiles
// (as many slabs as Q) and V tiles (VD / 64 slabs) of its 128-key steps in
// a ring of STAGES stages, running on into the next tile while the
// consumers finish this one. HD is the q/k width, VD the v width: (64, 64),
// (128, 128), or MLA's (96, 64), whose second Q/K slab is half zeros that
// TMA fills past the tensor's 96 columns (no device-memory read) and whose
// output accumulator is 32 floats a thread. Consumer c (warpgroups 1, 2)
// owns query rows 64c .. 64c + 63 of every tile. Accumulator fragment of
// wgmma (per warp w of a warpgroup, lane = 4 g + t): element 4 j + e is
// row 16 w + g + 8 (e / 2), column 8 j + 2 t + (e % 2). Which block takes
// a tile changes nothing in its arithmetic: two launches are bitwise equal.
template <typename T, int HD, int VD, int STAGES>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                   int* __restrict__ next, int B, int H, int KV, int S,
                   int Tk, float scale_log2, int causal, int window) {
  constexpr int SLABS = (HD + 63) / 64;  // of Q and K
  constexpr int V_SLABS = VD / 64;
  constexpr uint32_t Q_BYTES = WG_BQ * 128 * SLABS;
  constexpr uint32_t K_BYTES = WG_BK * 128 * SLABS;    // one K stage
  constexpr uint32_t V_BYTES = WG_BK * 128 * V_SLABS;  // one V stage
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  __shared__ int tile_id;                         // the tile in Q, or -1
  const uint32_t sQ = (smem_u32(smem_wg) + 1023u) & ~1023u;  // swizzle atom
  const uint32_t sK = sQ + Q_BYTES;
  const uint32_t sV = sK + STAGES * K_BYTES;
  const uint32_t bar_qfull = sV + STAGES * V_BYTES;
  const uint32_t bar_qempty = bar_qfull + 8;
  const uint32_t bar_full = bar_qempty + 8;            // [STAGES]
  const uint32_t bar_empty = bar_full + 8 * STAGES;    // [STAGES]
  const int n_work = ((S + WG_BQ - 1) / WG_BQ) * B * H;

  if (threadIdx.x == 0) {
    mbar_init(bar_qfull, 1);
    mbar_init(bar_qempty, 8);  // one arrival per consumer warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer --------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;  // K/V steps requested, over every tile of this block
      for (int j = 0;; ++j) {
        if (j > 0) mbar_wait(bar_qempty, (j - 1) & 1);  // Q is free
        const int w = j == 0 ? blockIdx.x : gridDim.x + atomicAdd(next, 1);
        tile_id = w < n_work ? w : -1;
        if (w >= n_work) {
          mbar_arrive(bar_qfull);  // no tile: the consumers stop
          break;
        }
        const Tile x = tile_of(w, B, H, S, Tk, causal, window);
        const int kvh = x.h / (H / KV);
        mbar_expect_tx(bar_qfull, Q_BYTES);
        for (int s = 0; s < SLABS; ++s)
          tma_load_4d(sQ + s * (WG_BQ * 128), &tq, bar_qfull, 64 * s, x.q0,
                      x.h, x.b);
        for (int i = 0; i < x.n_steps; ++i, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES)
            mbar_wait(bar_empty + 8 * st, (it / STAGES - 1) & 1);
          const uint32_t full = bar_full + 8 * st;
          mbar_expect_tx(full, K_BYTES + V_BYTES);
          const int k0 = x.kv_begin + i * WG_BK;
          for (int s = 0; s < SLABS; ++s)
            tma_load_4d(sK + st * K_BYTES + s * (WG_BK * 128), &tk, full,
                        64 * s, k0, kvh, x.b);
          for (int s = 0; s < V_SLABS; ++s)
            tma_load_4d(sV + st * V_BYTES + s * (WG_BK * 128), &tv, full,
                        64 * s, k0, kvh, x.b);
        }
      }
    }
  } else {
    // ---- consumers -------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const uint32_t qa = sQ + c * (64 * 128);  // its 64 rows of each slab

    // The two consumers take turns starting their products, over every
    // tile of the block: named barrier 1 + c is consumer c's turn, opened
    // by the other's arrival; consumer 0 goes first and takes one extra
    // turn at the very end to balance the arrivals. So one runs its
    // softmax while the other's products run. Each starts S_i = Q K_i^T
    // and then O += P_{i-1} V_{i-1}, and runs the softmax of S_i while the
    // second product is in flight. The first and the last step of a tile
    // are peeled off so that no wgmma sits under a branch.
    if (c == 1) named_arrive(1);
    int it = 0;  // K/V steps consumed, over every tile of this block
    for (int j = 0;; ++j) {
      mbar_wait(bar_qfull, j & 1);
      const int w = tile_id;
      if (w < 0) break;
      const Tile x = tile_of(w, B, H, S, Tk, causal, window);
      const int r0 = x.q0 + 64 * c;            // this consumer's first row
      const int row0 = r0 + 16 * warp + g;     // this lane's rows: +0, +8
      const Rows rows{r0, row0, t, Tk, causal, window, scale_log2};
      float acc[VD / 2];
#pragma unroll
      for (int i = 0; i < VD / 2; ++i) acc[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
      float sc[WG_BK / 2];         // S of this step, then its P in float32
      uint32_t pa[WG_BK / 16][4];  // P of the previous step, A fragments

      if (x.n_steps > 0) {
        mbar_wait(bar_full + 8 * (it % STAGES), (it / STAGES) & 1);
        named_sync(1 + c);
        qk_start<T, HD>(sc, qa, sK + (it % STAGES) * K_BYTES);
        named_arrive(2 - c);
        wgmma_wait<0>();
        fence_regs(sc);
        softmax_tile(sc, x.kv_begin, rows, m, l, alpha);
        pack_p<T>(pa, sc);
        for (int i = 1; i < x.n_steps; ++i) {
          const int st = (it + i) % STAGES;
          const int prev = (it + i - 1) % STAGES;
          mbar_wait(bar_full + 8 * st, ((it + i) / STAGES) & 1);
          named_sync(1 + c);
          qk_start<T, HD>(sc, qa, sK + st * K_BYTES);
          rescale(acc, alpha);
          pv_start<T, VD>(acc, pa, sV + prev * V_BYTES);
          named_arrive(2 - c);
          wgmma_wait<1>();
          fence_regs(sc);
          softmax_tile(sc, x.kv_begin + i * WG_BK, rows, m, l, alpha);
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(pa);
          release_stage(bar_empty + 8 * prev, lane);
          pack_p<T>(pa, sc);
        }
      }
      // every product with Q is done: the producer may load the next tile
      release_stage(bar_qempty, lane);
      if (x.n_steps > 0) {
        const int last = (it + x.n_steps - 1) % STAGES;
        rescale(acc, alpha);
        pv_start<T, VD>(acc, pa, sV + last * V_BYTES);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        release_stage(bar_empty + 8 * last, lane);
        it += x.n_steps;
      }

      T* ob = o + (static_cast<long long>(x.b) * H + x.h) * S * VD;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = row0 + 8 * r;
        if (s >= S) continue;
        const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int n = 0; n < VD / 8; ++n)
          *reinterpret_cast<uint32_t*>(&ob[static_cast<long long>(s) * VD +
                                           8 * n + 2 * t]) =
              pack_f<T>(acc[4 * n + 2 * r] / lc, acc[4 * n + 2 * r + 1] / lc);
      }
    }
    if (c == 0) named_sync(1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query
// (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (64-column x `rows`) box map of a (batch, heads, len, width) tensor of
// 16-bit elements with element strides sb, sh, sl (width contiguous), as
// the 4-D (width, len, heads, batch) TMA view, 128-byte swizzle; reads
// past len come back zero
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                int batch, int heads, int len, int width, long long sb,
                long long sh, long long sl, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// multiprocessors of the current device: the persistent grid's size
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <typename T, int HD, int VD, int STAGES>
int launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                 const CUtensorMap& tv, void* o, int* next, int B, int H,
                 int KV, int S, int Tk, float scale, int causal, int window,
                 cudaStream_t stream) {
  constexpr int slabs = (HD + 63) / 64;
  constexpr int smem = 1024 + WG_BQ * 128 * slabs +
                       STAGES * WG_BK * 128 * (slabs + VD / 64) + 16 +
                       16 * STAGES;
  auto kern = flash_wgmma_kernel<T, HD, VD, STAGES>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long work =
      static_cast<long long>((S + WG_BQ - 1) / WG_BQ) * H * B;
  const int sms = sm_count();
  if (work > 0x3fffffffLL || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(work < sms ? work : sms);
  kern<<<blocks, WG_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), next, B, H, KV, S, Tk, scale * LOG2E,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_wgmma(CUtensorMapDataType type, const void* q, const void* k,
                   const void* v, void* o, int* next, int B, int H, int KV,
                   int S, int Tk, int hd, int vd, const long long* st,
                   float scale, int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, type, q, B, H, S, hd, st[0], st[1], st[2], WG_BQ) ||
      !encode_map(&tk, type, k, B, KV, Tk, hd, st[3], st[4], st[5], WG_BK) ||
      !encode_map(&tv, type, v, B, KV, Tk, vd, st[6], st[7], st[8], WG_BK))
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64)
    return launch_wgmma<T, 64, 64, 3>(tq, tk, tv, o, next, B, H, KV, S, Tk,
                                      scale, causal, window, stream);
  if (hd == 96)
    return launch_wgmma<T, 96, 64, 3>(tq, tk, tv, o, next, B, H, KV, S, Tk,
                                      scale, causal, window, stream);
  return launch_wgmma<T, 128, 128, 3>(tq, tk, tv, o, next, B, H, KV, S, Tk,
                                      scale, causal, window, stream);
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

// The wgmma body: dtype 1 bfloat16, 2 float16; (hd, vd) in {(64, 64),
// (128, 128), (96, 64)};
// every stride a positive multiple of 8 elements and every base 16-byte
// aligned (what TMA reads). Anything else is refused
// (cudaErrorInvalidValue), never handed to another body. next: one int32
// on the device, 0 at the launch (the persistent blocks' tile counter).
int flash_attention_fwd_wgmma(int dtype, const void* q, const void* k,
                              const void* v, void* o, void* next, int B,
                              int H, int KV,
                              int S, int T, int hd, int vd, long long qsb,
                              long long qsh, long long qss, long long ksb,
                              long long ksh, long long kss, long long vsb,
                              long long vsh, long long vss, float scale,
                              int causal, int window, void* stream) {
  const long long st[9] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  bool ok = next != nullptr && B > 0 && H > 0 && KV > 0 && H % KV == 0 &&
            S > 0 && T > 0 &&
            ((hd == vd && (hd == 64 || hd == 128)) ||
             (hd == 96 && vd == 64)) &&
            (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
             reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  for (int i = 0; i < 9; ++i) ok = ok && st[i] > 0 && st[i] % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return dispatch_wgmma<__nv_bfloat16>(
          CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v, o,
          static_cast<int*>(next), B, H, KV, S, T, hd, vd, st, scale, causal,
          window, s);
    case 2:
      return dispatch_wgmma<__half>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, q, k, v,
                                    o, static_cast<int*>(next), B, H, KV, S,
                                    T, hd, vd, st, scale, causal, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
