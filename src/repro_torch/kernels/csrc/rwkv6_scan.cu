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
// GFLOP (0.08 ms at the float32 rate). The chunked form here does more:
// ~3 G MAC with chunks of 64, and it moves ~0.67 GB (the inputs once per
// pass, the chunk states written and read once).
//
// Design. Across chunks the recurrence is elementwise in the state's rows,
//   S_c[kk,:] = exp(clw_L,c[kk]) S_{c-1}[kk,:] + dS_c[kk,:],
// so the sequential part is small and independent per (b, h, kk). Two
// launches, one after the other on the caller's stream:
//  (a) state pass: one block per (h, b) walks the chunks in order, the
//      whole state in registers (4 x 4 per thread, the t-sum split over two
//      lanes) and the next chunk's k, logw and v prefetched into registers
//      while it works on this one, so each chunk is read once. It writes
//      the state entering every chunk but the first to a
//      (B, H, n_chunks - 1, K, K) scratch buffer, and the final state.
//  (b) output pass: one block per (chunk, h, b) (4,096 blocks at the main
//      shape, 2 per SM) reads its chunk and the state entering it and
//      writes the chunk's o. A is built in 4 x 4 blocks (OutShape below):
//      pairwise exponentials only inside the 16-row sub-blocks on the
//      diagonal (~31 K a chunk of 64 instead of ~129 K), the pairs across
//      sub-blocks as products of three factors that each keep their
//      exponent <= 0, with no exponential in the k loop.
// Each column's cumulative log decay is summed in order of t, as the plain
// version's cumsum, so the differences clw_a - clw_b come out as there.
// Both passes are float32 FMAs outside the tensor cores (TF32's 2^-11
// rounding is above the 1e-4 tolerance over 64-term sums). Positions past T
// are zero in shared memory (r = k = v = 0, logw = 0): they leave the state
// unchanged and are not written. No atomics and a fixed order of every sum:
// two launches are bitwise equal. Built without fast math; the pairwise
// exponentials use ex2.approx (2 ulp) with flush to zero.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int OUT_THREADS = 256;

// element strides of r, k, v, logw: (batch, time, head) each
struct Strides {
  long long s[12];
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Sums a column of L values `stride` apart in order of t, as the plain
// version's cumsum, the loads in batches of 8 ahead of the dependent adds.
// Without `incl` the column becomes its inclusive sum (clw); with it, incl
// gets the inclusive sum and the column the exclusive one, the sum less its
// own value (clw'). Returns the column's total.
template <int L>
__device__ __forceinline__ float cumsum_column(float* col, int stride,
                                               float* incl = nullptr) {
  float run = 0.f;
#pragma unroll
  for (int t0 = 0; t0 < L; t0 += 8) {
    float w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = col[(t0 + i) * stride];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      run += w[i];
      if (incl) {
        incl[(t0 + i) * stride] = run;
        col[(t0 + i) * stride] = run - w[i];
      } else {
        col[(t0 + i) * stride] = run;
      }
    }
  }
  return run;
}

// ---------------------------------------------------------------------------
// (a) state pass
// ---------------------------------------------------------------------------

// One block per (h, b) owns the whole K x K state, so each chunk's v is read
// once. Thread (tg, rg, cg) owns state rows 4 rg .. 4 rg + 3 and columns
// 4 cg .. 4 cg + 3 (in registers) and sums the chunk's rows t = tg (mod 2);
// the two lanes of a block add their halves, in one order, and keep the
// same state.
template <int L, int K>
struct StateShape {
  static constexpr int THREADS = 2 * (K / 4) * (K / 4);
  static constexpr int PK = K + 4;              // padded row of decayed k
  static constexpr int PER = L * K / THREADS;   // k, logw, v per thread
  static_assert(PER * THREADS == L * K, "chunk and head size do not tile");
  // floats: v [L][K], decayed k [L][PK], clw [L][K], exp(clw_L) [K]
  static constexpr int SMEM = L * K + L * PK + L * K + K;
};

template <int L, int K>
__global__ void __launch_bounds__(StateShape<L, K>::THREADS)
rwkv6_state_kernel(const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ lw, float* __restrict__ states,
                   float* __restrict__ s_out, int T, int H, const Strides sd) {
  using SS = StateShape<L, K>;
  constexpr int PK = SS::PK;
  extern __shared__ __align__(16) float sm[];
  float* vs = sm;             // [L][K]
  float* ks = vs + L * K;     // [L][PK] k, then decayed k
  float* cs = ks + L * PK;    // [L][K] logw, then clw
  float* wl = cs + L * K;     // [K] exp(clw_L) per state row

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tg = tid % 2;
  const int cg = (tid / 2) % (K / 4);
  const int rg = tid / (K / 2);
  const long long* st = sd.s;
  const float* kb = k + b * st[3] + h * st[5];
  const float* vb = v + b * st[6] + h * st[8];
  const float* wb = lw + b * st[9] + h * st[11];
  const int n_chunks = (T + L - 1) / L;
  const long long bh = static_cast<long long>(b) * H + h;

  // this chunk's k, logw and v (rows past T zero) wait in registers
  float kr[SS::PER], wr[SS::PER], vr[SS::PER];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int i = 0; i < SS::PER; ++i) {
      const int e = tid + i * SS::THREADS, t = e / K, kk = e % K;
      const bool in = c0 + t < T;
      kr[i] = in ? kb[(c0 + t) * st[4] + kk] : 0.f;
      wr[i] = in ? wb[(c0 + t) * st[10] + kk] : 0.f;
      vr[i] = in ? vb[(c0 + t) * st[7] + kk] : 0.f;
    }
  };

  float sv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sv[i][j] = 0.f;
  fetch(0);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk's shared reads are done
#pragma unroll
    for (int i = 0; i < SS::PER; ++i) {
      const int e = tid + i * SS::THREADS, t = e / K, kk = e % K;
      ks[t * PK + kk] = kr[i];
      cs[e] = wr[i];
      vs[e] = vr[i];
    }
    if (c + 1 < n_chunks) fetch((c + 1) * L);
    __syncthreads();

    // clw: the cumulative log decay of each column, summed in order of t
    // (as the plain version's cumsum), so exp(clw_L - clw_t) <= 1 matches
    if (tid < K) wl[tid] = expf(cumsum_column<L>(cs + tid, K));
    __syncthreads();
    for (int e = tid; e < L * K; e += SS::THREADS) {
      const int t = e / K, kk = e % K;
      ks[t * PK + kk] *= expf(cs[(L - 1) * K + kk] - cs[e]);
    }
    __syncthreads();

    // the state entering chunk c (c >= 1) goes to the scratch buffer; then
    // S <- exp(clw_L) S + sum_t (decayed k_t)^T v_t
    if (c > 0 && tg == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(states +
                                   ((bh * (n_chunks - 1) + c - 1) * K +
                                    4 * rg + i) * K + 4 * cg) =
            make_float4(sv[i][0], sv[i][1], sv[i][2], sv[i][3]);
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
#pragma unroll 4
    for (int t = tg; t < L; t += 2) {
      const float4 kd = *reinterpret_cast<const float4*>(&ks[t * PK + 4 * rg]);
      const float4 vv = *reinterpret_cast<const float4*>(&vs[t * K + 4 * cg]);
      const float kx[4] = {kd.x, kd.y, kd.z, kd.w};
      const float vx[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = fmaf(kx[i], vx[j], a[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float w = wl[4 * rg + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float both = a[i][j] + __shfl_xor_sync(0xffffffffu, a[i][j], 1);
        sv[i][j] = fmaf(w, sv[i][j], both);
      }
    }
  }
  if (tg == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(s_out + (bh * K + 4 * rg + i) * K + 4 * cg) =
          make_float4(sv[i][0], sv[i][1], sv[i][2], sv[i][3]);
}

// ---------------------------------------------------------------------------
// (b) output pass
// ---------------------------------------------------------------------------

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The chunk's L rows are NSB sub-blocks of 16. A (lower triangle) is cut into
// 4 x 4 blocks (rows t = 4 bi + i, columns tau = 4 bj + j), of three kinds:
//  * across sub-blocks (rows in sub-block I, columns in J < I): NF blocks,
//    one lane each, factorised through the sub-blocks' ends e_X = 16 X + 15,
//      exp(clw'_t - clw_tau) = exp(clw'_t - clw_{e_{I-1}})
//                              exp(clw_{e_{I-1}} - clw_{e_J})
//                              exp(clw_{e_J} - clw_tau),
//    every exponent <= 0: A = sum_k Qf[t,k] D_{I,J}[k] Gf[tau,k] with no
//    exponential in the loop;
//  * strictly lower inside a sub-block: NP blocks, KS lanes each (the k-sum
//    split, interleaved), pairwise exponentials;
//  * on the diagonal: ND blocks, KS lanes each: the pairs j < i and the u
//    bonus of the block's 4 rows.
template <int L, int K>
struct OutShape {
  static constexpr int NSB = L / 16;
  static constexpr int NF = 16 * NSB * (NSB - 1) / 2;
  static constexpr int NP = 6 * NSB;
  static constexpr int ND = 4 * NSB;
  static constexpr int KS = L == 64 ? 4 : (L == 32 ? 8 : 16);
  static constexpr int P = (K > L ? K : L) + 1;   // padded row, A phase
  static constexpr int PT = L + 4;                 // row of A^T and rd^T
  static constexpr int TILE =  // each region's floats
      cmax(cmax(L * P, K * K), cmax(K * PT, L * PT));
  static constexpr int VR = L * K / OUT_THREADS;  // v per thread
  static constexpr int SR = K * K / OUT_THREADS;  // state per thread
  static_assert(NF + (NP + ND) * KS <= OUT_THREADS && K % KS == 0 &&
                    NF % KS == 0 && KS <= 32,
                "A's blocks do not fit the block's threads");
  static_assert(VR * OUT_THREADS == L * K && SR * OUT_THREADS == K * K,
                "chunk and head size do not tile");
  // floats: six regions (r; k, then rd^T; clw'; clw, then A^T; Qf, then
  // v; Gf, then S), D [NSB][NSB][K], bonus [L], u [K]
  static constexpr int SMEM = 6 * TILE + NSB * NSB * K + L + K;
};

// exp(x) for x <= 0 through ex2.approx with flush to zero
__device__ __forceinline__ float exp_le0(float x) { return ex2(x * LOG2E); }

// Reads o through A: one block per (chunk, h, b).
template <int L, int K>
__global__ void __launch_bounds__(OUT_THREADS, 2)
rwkv6_output_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ lw,
                    const float* __restrict__ u,
                    const float* __restrict__ states, float* __restrict__ o,
                    int T, int H, const Strides sd) {
  using OS = OutShape<L, K>;
  constexpr int P = OS::P, KS = OS::KS;
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;                // [L][P] r
  float* ks = rs + OS::TILE;     // [L][P] k, then rd^T [K][PT]
  float* cp = ks + OS::TILE;     // [L][P] logw, then clw'
  float* ci = cp + OS::TILE;     // [L][P] clw, then A^T [L][PT]
  float* qf = ci + OS::TILE;     // [L][P] Qf, then v [L][K]
  float* gf = qf + OS::TILE;     // [L][P] Gf, then S [K][K]
  float* ds = gf + OS::TILE;     // [NSB][NSB][K]
  float* bonus = ds + OS::NSB * OS::NSB * K;  // [L]
  float* us = bonus + L;         // [K]

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int c0 = c * L;
  const long long* st = sd.s;
  const float* rb = r + b * st[0] + h * st[2];
  const float* kb = k + b * st[3] + h * st[5];
  const float* vb = v + b * st[6] + h * st[8];
  const float* wb = lw + b * st[9] + h * st[11];

  for (int e = tid; e < L * K; e += OUT_THREADS) {
    const int t = e / K, kk = e % K;
    const bool in = c0 + t < T;
    rs[t * P + kk] = in ? rb[(c0 + t) * st[1] + kk] : 0.f;
    ks[t * P + kk] = in ? kb[(c0 + t) * st[4] + kk] : 0.f;
    cp[t * P + kk] = in ? wb[(c0 + t) * st[10] + kk] : 0.f;
  }
  // v and the entering state wait in registers until A is done
  float vr[OS::VR], sr[OS::SR];
#pragma unroll
  for (int i = 0; i < OS::VR; ++i) {
    const int e = tid + i * OUT_THREADS, t = e / K;
    vr[i] = c0 + t < T ? vb[(c0 + t) * st[7] + e % K] : 0.f;
  }
  const int n_chunks = (T + L - 1) / L;
  const float* sp =
      states + ((static_cast<long long>(b) * H + h) * (n_chunks - 1) + c - 1) *
                   K * K;
#pragma unroll
  for (int i = 0; i < OS::SR; ++i)
    sr[i] = c == 0 ? 0.f : sp[tid + i * OUT_THREADS];
  for (int e = tid; e < K; e += OUT_THREADS) us[e] = u[h * K + e];
  __syncthreads();

  // clw and clw' = clw - logw, each column summed in order of t (as the
  // plain version's cumsum)
  if (tid < K) cumsum_column<L>(cp + tid, P, ci + tid);
  __syncthreads();

  // the factors of the across-sub-block pairs
  for (int e = tid; e < L * K; e += OUT_THREADS) {
    const int t = e / K, kk = e % K, sb = t / 16;
    if (sb >= 1)
      qf[t * P + kk] = rs[t * P + kk] *
                       expf(cp[t * P + kk] - ci[(16 * sb - 1) * P + kk]);
    if (sb + 1 < OS::NSB)
      gf[t * P + kk] = ks[t * P + kk] *
                       expf(ci[(16 * sb + 15) * P + kk] - ci[t * P + kk]);
  }
  for (int e = tid; e < OS::NSB * OS::NSB * K; e += OUT_THREADS) {
    const int I = e / (OS::NSB * K), J = (e / K) % OS::NSB, kk = e % K;
    if (J < I)
      ds[e] = expf(ci[(16 * I - 1) * P + kk] - ci[(16 * J + 15) * P + kk]);
  }
  __syncthreads();

  float a[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
  int bi = 0, bj = 0;
  bool writer = false;
  if (tid < OS::NF) {
    // across sub-blocks: (I, J) pair, then the 4 x 4 block (x, y) in it
    int w = tid / 16, I = 1;
    while (w >= I) {
      w -= I;
      ++I;
    }
    const int J = w;
    bi = 4 * I + (tid % 16) / 4;
    bj = 4 * J + tid % 4;
    const float* dd = ds + (I * OS::NSB + J) * K;
#pragma unroll 4
    for (int kk = 0; kk < K; ++kk) {
      const float d = dd[kk];
      float q[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        q[i] = qf[(4 * bi + i) * P + kk];
        g[i] = gf[(4 * bj + i) * P + kk] * d;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = fmaf(q[i], g[j], a[i][j]);
    }
    writer = true;
  } else if (tid < OS::NF + (OS::NP + OS::ND) * KS) {
    const int w = (tid - OS::NF) / KS, part = (tid - OS::NF) % KS;
    float bo[4] = {0.f, 0.f, 0.f, 0.f};
    if (w < OS::NP) {
      // strictly lower inside sub-block w / 6: the 6 blocks x > y
      const int sb = w / 6;
      int x = 1, y = w % 6;
      while (y >= x) {
        y -= x;
        ++x;
      }
      bi = 4 * sb + x;
      bj = 4 * sb + y;
      for (int kk = part; kk < K; kk += KS) {
        float rr[4], cc[4], kv[4], cl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rr[i] = rs[(4 * bi + i) * P + kk];
          cc[i] = cp[(4 * bi + i) * P + kk];
          kv[i] = ks[(4 * bj + i) * P + kk];
          cl[i] = ci[(4 * bj + i) * P + kk];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            a[i][j] = fmaf(rr[i] * kv[j], exp_le0(cc[i] - cl[j]), a[i][j]);
      }
    } else {
      // diagonal block: the pairs j < i, and the u bonus of its rows
      bi = bj = w - OS::NP;
      for (int kk = part; kk < K; kk += KS) {
        float rr[4], cc[4], kv[4], cl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rr[i] = rs[(4 * bi + i) * P + kk];
          cc[i] = cp[(4 * bi + i) * P + kk];
          kv[i] = ks[(4 * bi + i) * P + kk];
          cl[i] = ci[(4 * bi + i) * P + kk];
        }
        const float uk = us[kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bo[i] = fmaf(rr[i] * uk, kv[i], bo[i]);
#pragma unroll
          for (int j = 0; j < i; ++j)
            a[i][j] = fmaf(rr[i] * kv[j], exp_le0(cc[i] - cl[j]), a[i][j]);
        }
      }
    }
    // the KS lanes of this block (a group inside this branch) sum their parts
    const unsigned group =
        KS == 32 ? 0xffffffffu
                 : ((1u << KS) - 1u) << ((tid % 32) & ~(KS - 1));
#pragma unroll
    for (int sh = KS / 2; sh > 0; sh >>= 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bo[i] += __shfl_xor_sync(group, bo[i], sh);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a[i][j] += __shfl_xor_sync(group, a[i][j], sh);
      }
    }
    writer = part == 0;
    if (writer && w >= OS::NP)
#pragma unroll
      for (int i = 0; i < 4; ++i) bonus[4 * bi + i] = bo[i];
  }
  __syncthreads();  // every read of clw, Qf and Gf is done

  // A^T (A zero on and above the diagonal), rd^T = (r o exp(clw'))^T, v and
  // the entering state take the places of clw, k, Qf and Gf
  constexpr int PT = OS::PT;
  float* at = ci;   // [L][PT]: at[tau][t] = A[t][tau]
  float* rd = ks;   // [K][PT]: rd[kk][t]
  float* vs = qf;   // [L][K]
  float* ss = gf;   // [K][K]
  if (writer)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&at[(4 * bj + j) * PT + 4 * bi]) =
          make_float4(a[0][j], a[1][j], a[2][j], a[3][j]);
#pragma unroll
  for (int i = 0; i < OS::VR; ++i) vs[tid + i * OUT_THREADS] = vr[i];
#pragma unroll
  for (int i = 0; i < OS::SR; ++i) ss[tid + i * OUT_THREADS] = sr[i];
  for (int e = tid; e < L * K; e += OUT_THREADS) {
    const int t = e % L, kk = e / L;
    rd[kk * PT + t] = rs[t * P + kk] * expf(cp[t * P + kk]);
  }
  __syncthreads();

  // o[t][vv], t = 4 ti + i, vv = 4 vi + j:
  //   (r o exp(clw')) S + A v (tau up to the diagonal block) + bonus v
  for (int w = tid; w < (L / 4) * (K / 4); w += OUT_THREADS) {
    const int ti = w / (K / 4), vi = w % (K / 4);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < K; ++kk) {
      const float4 x4 = *reinterpret_cast<const float4*>(&rd[kk * PT + 4 * ti]);
      const float4 s4 = *reinterpret_cast<const float4*>(&ss[kk * K + 4 * vi]);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
      const float y[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
#pragma unroll 4
    for (int tau = 0; tau < 4 * ti + 4; ++tau) {
      const float4 x4 = *reinterpret_cast<const float4*>(&at[tau * PT + 4 * ti]);
      const float4 v4 = *reinterpret_cast<const float4*>(&vs[tau * K + 4 * vi]);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
      const float y[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * ti + i;
      if (c0 + t >= T) continue;
      const float bt = bonus[t];
      const float4 v4 = *reinterpret_cast<const float4*>(&vs[t * K + 4 * vi]);
      *reinterpret_cast<float4*>(
          o + ((static_cast<long long>(b) * T + c0 + t) * H + h) * K + 4 * vi) =
          make_float4(fmaf(bt, v4.x, acc[i][0]), fmaf(bt, v4.y, acc[i][1]),
                      fmaf(bt, v4.z, acc[i][2]), fmaf(bt, v4.w, acc[i][3]));
    }
  }
}

template <int L, int K>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, float* o, float* s_out, float* states, int B,
           int T, int H, const long long* st, int passes,
           cudaStream_t stream) {
  Strides sd;
  for (int i = 0; i < 12; ++i) sd.s[i] = st[i];
  const int n_chunks = (T + L - 1) / L;
  if (passes & 1) {
    using SS = StateShape<L, K>;
    const size_t smem = sizeof(float) * SS::SMEM;
    auto kern = rwkv6_state_kernel<L, K>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<dim3(H, B), SS::THREADS, smem, stream>>>(k, v, lw, states, s_out,
                                                    T, H, sd);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (passes & 2) {
    const size_t smem = sizeof(float) * OutShape<L, K>::SMEM;
    auto kern = rwkv6_output_kernel<L, K>;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<dim3(n_chunks, H, B), OUT_THREADS, smem, stream>>>(
        r, k, v, lw, u, states, o, T, H, sd);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// strides (elements): r b/t/h, k b/t/h, v b/t/h, logw b/t/h. chunk and K
// each in {16, 32, 64}. states: (B, H, ceil(T / chunk) - 1, K, K) float32
// scratch. passes: 1 the state pass (writes states and s_out), 2 the output
// pass (reads states, writes o), 3 both in that order. Returns a
// cudaError_t.
int rwkv6_scan_fwd(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, void* o, void* s_out,
                   void* states, int B, int T, int H, int K, int chunk,
                   const long long* strides, int passes, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535 || passes < 1 ||
      passes > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a[5] = {static_cast<const float*>(r),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v),
                       static_cast<const float*>(logw),
                       static_cast<const float*>(u)};
  float* out = static_cast<float*>(o);
  float* so = static_cast<float*>(s_out);
  float* sc = static_cast<float*>(states);
#define RWKV_CASE(LL, KK)                                                    \
  if (chunk == LL && K == KK)                                                \
    return launch<LL, KK>(a[0], a[1], a[2], a[3], a[4], out, so, sc, B, T, H, \
                          strides, passes, s);
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
