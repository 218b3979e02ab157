// Tensor-core device code of the bf16 attention backward (attention_bwd.cu).
// The fp32 backward keeps the scalar kernels of attention_bwd.cu.
//
// Same split and formulas as the scalar kernels, with every product on
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate). A CTA is 4 warps, and a
// warp owns 16 rows of its kernel's M dimension:
//   dQ kernel, one CTA per 64 query rows, one pass over key tiles of BK;
//     prologue  D'_i = rowsum(dO * O) from the forward's bf16 output
//     per tile  S = Q K^T, P = exp(S - lse) (lse from the forward),
//               dP = dO V^T, dS' = P (dP f - D'_i),
//               dQ' += dS' K, A += P K, D_i += rowsum(P * dP * f)
//     end       dQ = dQ' - (D_i - D'_i) A
//   dK/dV kernel, one CTA per 64 keys, query tiles of BQ
//     S^T = K Q^T, P^T = exp(S^T - lse), dP^T = V dO^T,
//     dV += (P^T f) dO, dK += dS^T Q                          (P~, dS rounded to bf16)
// where f is the dropout factor keep / (1 - rate) of philox.cuh. 8 products
// a call. dQ is exact algebra: dS = P (dP f - D_i) = dS' - (D_i - D'_i) P.
// D'_i alone would leave the bf16 rounding of O, 2^-9 of |dP|, in dS where
// dS cancels exactly (a row of one key: P = 1, dS = 0); with the fp32 D_i
// summed in the same pass it enters only through the bf16 roundings of dS'
// and A, at 2^-9 of 2^-9. The dK/dV kernel reads the exact D_i.
// Neither kernel draws the mask: both read the words the forward kernel
// stored, one bit per element (philox.cuh, store_keep_words).
//
// Tiles: each operand is one row-major [row][d] tile in shared memory, its
// rows padded by 16 bytes so that the 8 rows an ldmatrix reads fall in 8
// distinct bank groups. A fragments and the B fragments of the products
// over d come from ldmatrix, those of the products over the rows (dQ += dS K,
// A += P K, dV += P~^T dO, dK += dS^T Q) from ldmatrix.trans of the same
// tile, so nothing is stored twice. Each CTA keeps its own 64 rows (Q, dO
// and O, or K and V) in shared memory, and the streamed tiles (K, V, the key
// bias; or Q, dO, lse, D_i, the keep words) go through a two-stage cp.async
// ring: the next tile loads while the current one computes, and no thread
// waits on a load of its own. BK = BQ = 64 at D 64 and 32 at D 96/128.
// The sums are fp32; D_i goes through device memory [B, H, Lq] from the
// first kernel to the second. No atomics.
#pragma once

#include "attention_mma.cuh"

namespace k3m {

struct BwdArgs {
  AttnArgs f;           // q, k, v, bias; f.out and its strides are dO
  const void* o;        // the forward's output [B, Lq, H, D] (strided)
  long long o_sb, o_sl, o_sh;
  const float* lse;     // [B, H, Lq] from the forward
  float* delta;         // [B, H, Lq] scratch: D_i, written by the dQ kernel
  const uint32_t* keep_words;  // [B, H, Lq, ceil(Lk / 32)] under dropout, from the
                               // forward: bit k % 32 of word k / 32 keeps (q, k)
  void* dq;             // contiguous [B, Lq, H, D]
  void* dk;             // contiguous [B, Lk, H, D]
  void* dv;
};

constexpr float kLog2e = 1.4426950408889634f;

// rows of the streamed tiles: 64 where the registers allow, else 32
template <int D>
constexpr int bwd_tile() { return D <= 64 ? 64 : 32; }

template <int D>
struct DqMmaSmem {
  static constexpr int BK = bwd_tile<D>();
  __nv_bfloat16 q[kMmaBQ][D + kPad];
  __nv_bfloat16 dout[kMmaBQ][D + kPad];
  __nv_bfloat16 o[kMmaBQ][D + kPad];    // the forward's output, for D'_i
  __nv_bfloat16 k[2][BK][D + kPad];
  __nv_bfloat16 v[2][BK][D + kPad];
  float bias[2][BK];
  uint32_t keep[2][kMmaBQ][BK / 32];   // keep words of the tile's keys, per query row
};

template <int D>
struct DkvMmaSmem {
  static constexpr int BQ = bwd_tile<D>();
  __nv_bfloat16 k[kMmaBQ][D + kPad];
  __nv_bfloat16 v[kMmaBQ][D + kPad];
  __nv_bfloat16 q[2][BQ][D + kPad];
  __nv_bfloat16 dout[2][BQ][D + kPad];
  float lse[2][BQ];
  float delta[2][BQ];
  uint32_t keep[2][BQ][2];    // keep words of the CTA's 64 keys, per query
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zeros where !valid (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronous; zero where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lane l gives a row address of matrix l / 8
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// rows [r0, r0 + ROWS) of a [L, D] bf16 operand into `dst` [row][d] with
// cp.async (not yet committed); zeros past `n`
template <int ROWS, int D>
__device__ __forceinline__ void cp_tile(__nv_bfloat16 (*dst)[D + kPad], const __nv_bfloat16* base,
                                        long long sl, int r0, int n) {
  constexpr int kVecs = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * kVecs; idx += kMmaThreads) {
    const int j = idx / kVecs, d = (idx % kVecs) * 8, r = r0 + j;
    const bool ok = r < n;
    cp_async16(&dst[j][d], base + (ok ? r : 0) * sl + d, ok);
  }
}

// elements [i0, i0 + N) of an fp32 row into `dst` with cp.async (not yet
// committed); zeros past `n`
template <int N>
__device__ __forceinline__ void cp_row(float* dst, const float* src, int i0, int n) {
  for (int i = threadIdx.x; i < N; i += kMmaThreads) {
    const bool ok = i0 + i < n;
    cp_async4(dst + i, src + (ok ? i0 + i : 0), ok);
  }
}

// acc[NB][4] = A (16 rows [a0, a0 + 16) of `at` [row][d]) times B,
// B[d][n] = bt[n][d] for the NB * 8 rows of `bt`: a product over d
// (S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T)
template <int D, int NB>
__device__ __forceinline__ void mma_over_d(float (&acc)[NB][4], const __nv_bfloat16 (*at)[D + kPad],
                                           int a0, const __nv_bfloat16 (*bt)[D + kPad], int lane) {
  const int row = (lane & 7) + ((lane >> 4) << 3), col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4];
    ldsm4(fa, &at[a0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      uint32_t b[4];
      ldsm4(b, &bt[np * 16 + row][kk * 16 + col]);
      mma_bf16(acc[2 * np], fa, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], fa, b[2], b[3]);
    }
  }
}

// C-layout fp32 [16 x 8*NB] -> bf16 A fragments [16 x 16] x NB/2
template <int NB>
__device__ __forceinline__ void to_a_frags(uint32_t (&fa)[NB / 2][4], const float (&c)[NB][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    fa[nb / 2][(nb % 2) * 2 + 0] = pack_bf16(c[nb][0], c[nb][1]);
    fa[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(c[nb][2], c[nb][3]);
  }
}

// acc[D/8][4] += A (16 x 8*NB, fragments fa) times the rows of `bt`
// ([8*NB][D] row-major: B[row][d], a product over the rows), B fragments
// from ldmatrix.trans
template <int D, int NB>
__device__ __forceinline__ void mma_over_rows(float (&acc)[D / 8][4],
                                              const uint32_t (&fa)[NB / 2][4],
                                              const __nv_bfloat16 (*bt)[D + kPad], int lane) {
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldsm4_t(b, &bt[kk * 16 + row][dp * 16 + col]);
      mma_bf16(acc[2 * dp], fa[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], fa[kk], b[2], b[3]);
    }
  }
}

// the dropout factors of the four C-layout elements whose keep bits are `bits`
__device__ __forceinline__ void drop_factors(float (&f)[4], uint32_t bits, float keep_scale) {
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = (bits >> e) & 1u ? keep_scale : 0.f;
}

__device__ __forceinline__ float2 bf16x2_to_f2(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// rowsum(x * y) of rows r and r + 8 of two shared [row][d] bf16 tiles in
// fp32, each thread reading the columns of its A-fragment positions; the 4
// lanes of a row add in a fixed order
template <int D>
__device__ __forceinline__ void row_dot(float& d0, float& d1, const __nv_bfloat16 (*x)[D + kPad],
                                        const __nv_bfloat16 (*y)[D + kPad], int r, int t) {
  d0 = d1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = r + (e & 1) * 8, c = kk * 16 + 2 * t + (e >> 1) * 8;
      const float2 u = bf16x2_to_f2(ld32(&x[rr][c])), w = bf16x2_to_f2(ld32(&y[rr][c]));
      (e & 1 ? d1 : d0) += u.x * w.x + u.y * w.y;
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, off);
    d1 += __shfl_xor_sync(0xffffffffu, d1, off);
  }
}

// dQ kernel body: 64 query rows at q0 of head (b, h).
template <int D>
__device__ __forceinline__ void attn_bwd_dq_mma(const BwdArgs& g, int b, int h, int q0,
                                                DqMmaSmem<D>& s) {
  constexpr int BK = DqMmaSmem<D>::BK;
  constexpr int kNB = BK / 8;        // n-blocks of S per key tile
  const AttnArgs& a = g.f;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t = lane % 4;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.out) + b * a.o_sb + h * a.o_sh;
  const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(g.o) + b * g.o_sb + h * g.o_sh;
  const float* bias = a.bias + b * a.bias_sb;
  const int r0 = q0 + warp * 16 + gr, r1 = r0 + 8;
  const long long row_base = (static_cast<long long>(b) * a.heads + h) * a.lq;
  const int tiles = (a.lk + BK - 1) / BK;

  const int nwords = (a.lk + 31) / 32;
  // stage st <- key tile at k0: K, V, the key bias and the keep words of
  // this CTA's rows
  auto issue = [&](int st, int k0) {
    cp_tile<BK, D>(s.k[st], k, a.k_sl, k0, a.lk);
    cp_tile<BK, D>(s.v[st], v, a.v_sl, k0, a.lk);
    cp_row<BK>(s.bias[st], bias, k0, a.lk);
    if (a.keep_min) {
      for (int i = tid; i < kMmaBQ * (BK / 32); i += kMmaThreads) {
        const int qi = q0 + i / (BK / 32), word = k0 / 32 + i % (BK / 32);
        const bool ok = qi < a.lq && word < nwords;
        cp_async4(&s.keep[st][i / (BK / 32)][i % (BK / 32)],
                  g.keep_words + (ok ? (row_base + qi) * nwords + word : 0), ok);
      }
    }
    cp_async_commit();
  };
  cp_tile<kMmaBQ, D>(s.q, q, a.q_sl, q0, a.lq);   // committed with stage 0
  cp_tile<kMmaBQ, D>(s.dout, dout, a.o_sl, q0, a.lq);
  cp_tile<kMmaBQ, D>(s.o, o, g.o_sl, q0, a.lq);
  issue(0, 0);

  float da0 = 0.f, da1 = 0.f;        // D'_i of rows r0, r1 (zero rows past Lq)
  // log2-domain lse; rows past Lq: +inf gives P = 0
  const float lse0 = r0 < a.lq ? g.lse[row_base + r0] * kLog2e : INFINITY;
  const float lse1 = r1 < a.lq ? g.lse[row_base + r1] * kLog2e : INFINITY;
  const float scale2 = a.scale * kLog2e;

  float dt0 = 0.f, dt1 = 0.f;        // D_i of rows r0, r1 (this lane's keys)
  float acc[D / 8][4], pk[D / 8][4];  // dQ' and A = P K
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    pk[i][0] = pk[i][1] = pk[i][2] = pk[i][3] = 0.f;
  }
  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1, k0 = it * BK;
    if (it + 1 < tiles) {
      issue(st ^ 1, k0 + BK);   // that stage was consumed before the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) row_dot<D>(da0, da1, s.dout, s.o, warp * 16 + gr, t);

    float p[kNB][4], dp[kNB][4];
    mma_over_d<D, kNB>(p, s.q, warp * 16, s.k[st], lane);      // S = Q K^T
    mma_over_d<D, kNB>(dp, s.dout, warp * 16, s.v[st], lane);  // dP = dO V^T
    const bool ragged = k0 + BK > a.lk;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      float f[4] = {1.f, 1.f, 1.f, 1.f};
      if (a.keep_min) {
        // keys c, c + 1 of rows r0, r1: bits c % 32, c % 32 + 1 of word c / 32
        const int c = nb * 8 + 2 * t, w = c / 32, sh = c % 32;
        const uint32_t w0 = s.keep[st][warp * 16 + gr][w] >> sh;
        const uint32_t w1 = s.keep[st][warp * 16 + gr + 8][w] >> sh;
        drop_factors(f, (w0 & 3u) | (w1 & 3u) << 2, a.keep_scale);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nb * 8 + 2 * t + (e & 1);
        float pe = exp2f(fmaf(p[nb][e], scale2,
                              fmaf(s.bias[st][c], kLog2e, -(e < 2 ? lse0 : lse1))));
        if (ragged && k0 + c >= a.lk) pe = 0.f;   // past Lk
        const float dpf = dp[nb][e] * f[e];
        if (e < 2) dt0 += pe * dpf; else dt1 += pe * dpf;
        dp[nb][e] = pe * (dpf - (e < 2 ? da0 : da1));   // dS'
        p[nb][e] = pe;
      }
    }
    uint32_t dsa[kNB / 2][4], pa[kNB / 2][4];
    to_a_frags<kNB>(dsa, dp);
    to_a_frags<kNB>(pa, p);
    mma_over_rows<D, kNB>(acc, dsa, s.k[st], lane);   // dQ' += dS' K
    mma_over_rows<D, kNB>(pk, pa, s.k[st], lane);     // A += P K
    __syncthreads();   // stage st is consumed
  }

  // D_i: the 4 lanes of a row add in a fixed order
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    dt0 += __shfl_xor_sync(0xffffffffu, dt0, off);
    dt1 += __shfl_xor_sync(0xffffffffu, dt1, off);
  }
  if (t == 0) {
    if (r0 < a.lq) g.delta[row_base + r0] = dt0;
    if (r1 < a.lq) g.delta[row_base + r1] = dt1;
  }
  const float c0 = dt0 - da0, c1 = dt1 - da1;
  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(g.dq) +
                      (static_cast<long long>(b) * a.lq * a.heads + h) * D;
  const long long row_stride = static_cast<long long>(a.heads) * D;
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
    const int c = db * 8 + 2 * t;
    if (r0 < a.lq)
      *reinterpret_cast<uint32_t*>(dq + r0 * row_stride + c) =
          pack_bf16((acc[db][0] - c0 * pk[db][0]) * a.scale,
                    (acc[db][1] - c0 * pk[db][1]) * a.scale);
    if (r1 < a.lq)
      *reinterpret_cast<uint32_t*>(dq + r1 * row_stride + c) =
          pack_bf16((acc[db][2] - c1 * pk[db][2]) * a.scale,
                    (acc[db][3] - c1 * pk[db][3]) * a.scale);
  }
}

// dK/dV kernel body: 64 keys at k0 of head (b, h).
template <int D>
__device__ __forceinline__ void attn_bwd_dkv_mma(const BwdArgs& g, int b, int h, int k0,
                                                 DkvMmaSmem<D>& s) {
  constexpr int BQ = DkvMmaSmem<D>::BQ;
  constexpr int kNB = BQ / 8;        // n-blocks of S^T per query tile
  const AttnArgs& a = g.f;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t = lane % 4;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.out) + b * a.o_sb + h * a.o_sh;
  const long long row_base = (static_cast<long long>(b) * a.heads + h) * a.lq;
  const int j0 = k0 + warp * 16 + gr, j1 = j0 + 8;     // this thread's two keys
  const float kb0 = j0 < a.lk ? a.bias[b * a.bias_sb + j0] * kLog2e : -INFINITY;
  const float kb1 = j1 < a.lk ? a.bias[b * a.bias_sb + j1] * kLog2e : -INFINITY;
  const float scale2 = a.scale * kLog2e;
  const int tiles = (a.lq + BQ - 1) / BQ;
  const int nwords = (a.lk + 31) / 32;

  // stage st <- query tile at q0: Q, dO, lse, D_i and the keep words of
  // this CTA's two 32-key groups
  auto issue = [&](int st, int q0) {
    cp_tile<BQ, D>(s.q[st], q, a.q_sl, q0, a.lq);
    cp_tile<BQ, D>(s.dout[st], dout, a.o_sl, q0, a.lq);
    cp_row<BQ>(s.lse[st], g.lse + row_base, q0, a.lq);
    cp_row<BQ>(s.delta[st], g.delta + row_base, q0, a.lq);
    if (a.keep_min) {
      for (int i = tid; i < 2 * BQ; i += kMmaThreads) {
        const int qi = q0 + i / 2, word = k0 / 32 + (i & 1);
        const bool ok = qi < a.lq && word < nwords;
        cp_async4(&s.keep[st][i / 2][i & 1],
                  g.keep_words + (ok ? (row_base + qi) * nwords + word : 0), ok);
      }
    }
    cp_async_commit();
  };
  cp_tile<kMmaBQ, D>(s.k, k, a.k_sl, k0, a.lk);   // committed with stage 0
  cp_tile<kMmaBQ, D>(s.v, v, a.v_sl, k0, a.lk);
  issue(0, 0);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1, q0 = it * BQ;
    if (it + 1 < tiles) {
      issue(st ^ 1, q0 + BQ);   // that stage was consumed before the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    float pt[kNB][4], dpt[kNB][4];
    mma_over_d<D, kNB>(pt, s.k, warp * 16, s.q[st], lane);       // S^T = K Q^T
    mma_over_d<D, kNB>(dpt, s.v, warp * 16, s.dout[st], lane);   // dP^T = V dO^T
    const bool ragged = q0 + BQ > a.lq;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const int c = nb * 8 + 2 * t;           // query column within the tile
      float f[4] = {1.f, 1.f, 1.f, 1.f};
      if (a.keep_min) {
        // keys j0, j1 share the word (warp / 2) of the CTA's two
        const uint32_t wa = s.keep[st][c][warp >> 1], wb = s.keep[st][c + 1][warp >> 1];
        const int p0 = (warp & 1) * 16 + gr, p1 = p0 + 8;
        drop_factors(f, ((wa >> p0) & 1u) | ((wb >> p0) & 1u) << 1 | ((wa >> p1) & 1u) << 2 |
                            ((wb >> p1) & 1u) << 3,
                     a.keep_scale);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = c + (e & 1);
        float p = exp2f(fmaf(pt[nb][e], scale2,
                             fmaf(s.lse[st][qc], -kLog2e, e < 2 ? kb0 : kb1)));
        if (ragged && q0 + qc >= a.lq) p = 0.f;   // past Lq
        pt[nb][e] = p * f[e];                                      // P~^T
        dpt[nb][e] = p * (dpt[nb][e] * f[e] - s.delta[st][qc]);    // dS^T
      }
    }
    uint32_t pa[kNB / 2][4], dsa[kNB / 2][4];
    to_a_frags<kNB>(pa, pt);
    to_a_frags<kNB>(dsa, dpt);
    mma_over_rows<D, kNB>(dva, pa, s.dout[st], lane);   // dV += P~^T dO
    mma_over_rows<D, kNB>(dka, dsa, s.q[st], lane);     // dK += dS^T Q
    __syncthreads();   // stage st is consumed
  }

  __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(g.dk);
  __nv_bfloat16* dv = static_cast<__nv_bfloat16*>(g.dv);
  const long long row_stride = static_cast<long long>(a.heads) * D;
  const long long base = (static_cast<long long>(b) * a.lk * a.heads + h) * D;
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
    const int c = db * 8 + 2 * t;
    if (j0 < a.lk) {
      *reinterpret_cast<uint32_t*>(dk + base + j0 * row_stride + c) =
          pack_bf16(dka[db][0] * a.scale, dka[db][1] * a.scale);
      *reinterpret_cast<uint32_t*>(dv + base + j0 * row_stride + c) =
          pack_bf16(dva[db][0], dva[db][1]);
    }
    if (j1 < a.lk) {
      *reinterpret_cast<uint32_t*>(dk + base + j1 * row_stride + c) =
          pack_bf16(dka[db][2] * a.scale, dka[db][3] * a.scale);
      *reinterpret_cast<uint32_t*>(dv + base + j1 * row_stride + c) =
          pack_bf16(dva[db][2], dva[db][3]);
    }
  }
}

}  // namespace k3m
