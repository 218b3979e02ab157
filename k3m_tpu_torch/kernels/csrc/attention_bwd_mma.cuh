// Tensor-core device code of the bf16 attention backward (attention_bwd.cu).
// The fp32 backward keeps the scalar kernels of attention_bwd.cu.
//
// Same split and formulas as the scalar kernels, with every product on
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate; fragment helpers of
// attention_mma.cuh). A warp owns 16 rows of its kernel's M dimension:
//   dQ kernel, one CTA per 64 query rows, key tiles of 32 in shared memory
//     pass 1  S = Q K^T                 -> row max, sum -> lse
//     pass 2  S, dP = dO V^T            -> D_i = rowsum(P * dP * f)
//     pass 3  S, dP, dS = P (dP f - D_i) -> dQ += dS K      (dS rounded to bf16)
//   dK/dV kernel, one CTA per 64 keys, query tiles of 32 in shared memory
//     S^T = K Q^T, P^T = exp(S^T - lse), dP^T = V dO^T,
//     dV += (P^T f) dO, dK += dS^T Q                          (P~, dS rounded to bf16)
// where f is the dropout factor keep / (1 - rate) of philox.cuh. Q, dO (dQ
// kernel) and K, V (dK/dV kernel) stay in registers as A fragments; the
// other operand's tile is stored row-major ([row][d], for products over d)
// and transposed ([d][row], for products over the rows) in shared memory.
// The statistics and all sums are fp32; lse and D_i go through device
// memory [B, H, Lq] from the first kernel to the second. No atomics.
#pragma once

#include "attention_mma.cuh"

namespace k3m {

constexpr int kBwdBK = 32;   // keys per shared tile (dQ kernel)
constexpr int kBwdBQ = 32;   // queries per shared tile (dK/dV kernel)

template <int D>
struct DqMmaSmem {
  __nv_bfloat16 k[kBwdBK][D + kPad];    // [key][d]: B operand of S = Q K^T
  __nv_bfloat16 v[kBwdBK][D + kPad];    // [key][d]: B operand of dP = dO V^T
  __nv_bfloat16 kt[D][kBwdBK + kPad];   // [d][key]: B operand of dQ = dS K
  float bias[kBwdBK];
};

template <int D>
struct DkvMmaSmem {
  __nv_bfloat16 q[kBwdBQ][D + kPad];    // [q][d]: B operand of S^T = K Q^T
  __nv_bfloat16 dout[kBwdBQ][D + kPad]; // [q][d]: B operand of dP^T = V dO^T
  __nv_bfloat16 qt[D][kBwdBQ + kPad];   // [d][q]: B operand of dK = dS^T Q
  __nv_bfloat16 dot[D][kBwdBQ + kPad];  // [d][q]: B operand of dV = P~^T dO
  float lse[kBwdBQ];
  float delta[kBwdBQ];
};

// rows [r0, r0 + ROWS) of a [L, D] bf16 operand into `rowmajor` [row][d]
// and, if given, `transposed` [d][row]; zeros past `n`. 16-byte loads.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16 (*rowmajor)[D + kPad],
                                               __nv_bfloat16 (*transposed)[ROWS + kPad],
                                               const __nv_bfloat16* base, long long sl,
                                               int r0, int n) {
  constexpr int kVecs = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * kVecs; idx += kMmaThreads) {
    const int j = idx % ROWS, d = (idx / ROWS) * 8, r = r0 + j;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r < n) w = *reinterpret_cast<const uint4*>(base + r * sl + d);
    if (rowmajor != nullptr) *reinterpret_cast<uint4*>(&rowmajor[j][d]) = w;
    if (transposed != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
      for (int i = 0; i < 8; ++i) transposed[d + i][j] = e[i];
    }
  }
}

// A fragments of rows r0 (and r0 + 8) of a [L, D] bf16 operand, zeros past n
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&fa)[D / 16][4],
                                             const __nv_bfloat16* base, long long sl,
                                             int r0, int n, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    fa[kk][0] = r0 < n ? ld32(base + r0 * sl + c) : 0u;
    fa[kk][1] = r1 < n ? ld32(base + r1 * sl + c) : 0u;
    fa[kk][2] = r0 < n ? ld32(base + r0 * sl + c + 8) : 0u;
    fa[kk][3] = r1 < n ? ld32(base + r1 * sl + c + 8) : 0u;
  }
}

// acc[NB][4] += A (16 x D, fragments fa) times the rows of `bt` ([NB*8][D])
template <int D, int NB>
__device__ __forceinline__ void mma_rows(float (&acc)[NB][4], const uint32_t (&fa)[D / 16][4],
                                         const __nv_bfloat16 (*bt)[D + kPad], int g, int t) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* p = &bt[nb * 8 + g][kk * 16 + 2 * t];
      mma_bf16(acc[nb], fa[kk], ld32(p), ld32(p + 8));
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

// acc[D/8][4] += A (16 x 8*NB, fragments fa) times bt^T, bt = [D][8*NB] rows
template <int D, int NB, int W>
__device__ __forceinline__ void mma_cols(float (&acc)[D / 8][4], const uint32_t (&fa)[NB / 2][4],
                                         const __nv_bfloat16 (*bt)[W + kPad], int g, int t) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
#pragma unroll
    for (int db = 0; db < D / 8; ++db) {
      const __nv_bfloat16* p = &bt[db * 8 + g][kk * 16 + 2 * t];
      mma_bf16(acc[db], fa[kk], ld32(p), ld32(p + 8));
    }
  }
}

// dropout factor of element (q, k) (1 without dropout)
__device__ __forceinline__ float mma_drop(const AttnArgs& a, uint32_t bh, int q, int k) {
  if (!a.keep_min) return 1.f;
  return keep(a.seed, bh, q, k, a.keep_min) * a.keep_scale;
}

// dQ kernel body: 64 query rows at q0 of head (b, h). dout is a.out.
template <int D>
__device__ __forceinline__ void attn_bwd_dq_mma(const AttnArgs& a, int b, int h, int q0,
                                                __nv_bfloat16* dq, float* lse_out,
                                                float* delta_out, DqMmaSmem<D>& s) {
  constexpr int kNB = kBwdBK / 8;    // n-blocks of S per key tile
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t bh = b * a.heads + h;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.out) + b * a.o_sb + h * a.o_sh;
  const float* bias = a.bias + b * a.bias_sb;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a_frags<D>(qa, q, a.q_sl, r0, a.lq, t);
  load_a_frags<D>(da, dout, a.o_sl, r0, a.lq, t);

  auto load = [&](int k0, bool with_v) {
    __syncthreads();   // the previous tile is consumed
    load_tile_bf16<kBwdBK, D>(s.k, with_v ? s.kt : nullptr, k, a.k_sl, k0, a.lk);
    if (with_v) load_tile_bf16<kBwdBK, D>(s.v, nullptr, v, a.v_sl, k0, a.lk);
    if (tid < kBwdBK) s.bias[tid] = k0 + tid < a.lk ? bias[k0 + tid] : -INFINITY;
    __syncthreads();
  };
  // S of this tile, scaled and biased (-inf past Lk)
  auto scores = [&](float (&sc)[kNB][4]) {
    mma_rows<D, kNB>(sc, qa, s.k, g, t);
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const int c = nb * 8 + 2 * t;
      sc[nb][0] = sc[nb][0] * a.scale + s.bias[c];
      sc[nb][1] = sc[nb][1] * a.scale + s.bias[c + 1];
      sc[nb][2] = sc[nb][2] * a.scale + s.bias[c];
      sc[nb][3] = sc[nb][3] * a.scale + s.bias[c + 1];
    }
  };

  // pass 1: lse (every tile holds a real key, so the maxima stay finite)
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  for (int k0 = 0; k0 < a.lk; k0 += kBwdBK) {
    load(k0, false);
    float sc[kNB][4];
    scores(sc);
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      t0 = fmaxf(t0, fmaxf(sc[nb][0], sc[nb][1]));
      t1 = fmaxf(t1, fmaxf(sc[nb][2], sc[nb][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, off));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, off));
    }
    const float mn0 = fmaxf(m0, t0), mn1 = fmaxf(m1, t1);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      s0 += expf(sc[nb][0] - mn0) + expf(sc[nb][1] - mn0);
      s1 += expf(sc[nb][2] - mn1) + expf(sc[nb][3] - mn1);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    l0 = l0 * expf(m0 - mn0) + s0;
    l1 = l1 * expf(m1 - mn1) + s1;
    m0 = mn0;
    m1 = mn1;
  }
  const float lse0 = m0 + logf(l0), lse1 = m1 + logf(l1);

  // probabilities P and dP f of this tile (dP = dO V^T times the dropout factor)
  auto probs_dp = [&](int k0, float (&p)[kNB][4], float (&dp)[kNB][4]) {
    scores(p);
    mma_rows<D, kNB>(dp, da, s.v, g, t);
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const int c = k0 + nb * 8 + 2 * t;
      p[nb][0] = expf(p[nb][0] - lse0);
      p[nb][1] = expf(p[nb][1] - lse0);
      p[nb][2] = expf(p[nb][2] - lse1);
      p[nb][3] = expf(p[nb][3] - lse1);
      dp[nb][0] *= mma_drop(a, bh, r0, c);
      dp[nb][1] *= mma_drop(a, bh, r0, c + 1);
      dp[nb][2] *= mma_drop(a, bh, r1, c);
      dp[nb][3] *= mma_drop(a, bh, r1, c + 1);
    }
  };

  // pass 2: D_i = rowsum(P * dP f)
  float dl0 = 0.f, dl1 = 0.f;
  for (int k0 = 0; k0 < a.lk; k0 += kBwdBK) {
    load(k0, true);
    float p[kNB][4], dp[kNB][4];
    probs_dp(k0, p, dp);
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      dl0 += p[nb][0] * dp[nb][0] + p[nb][1] * dp[nb][1];
      dl1 += p[nb][2] * dp[nb][2] + p[nb][3] * dp[nb][3];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    dl0 += __shfl_xor_sync(0xffffffffu, dl0, off);
    dl1 += __shfl_xor_sync(0xffffffffu, dl1, off);
  }

  // pass 3: dS = P (dP f - D_i), dQ += dS K
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int k0 = 0; k0 < a.lk; k0 += kBwdBK) {
    load(k0, true);
    float p[kNB][4], dp[kNB][4];
    probs_dp(k0, p, dp);
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      p[nb][0] *= dp[nb][0] - dl0;
      p[nb][1] *= dp[nb][1] - dl0;
      p[nb][2] *= dp[nb][2] - dl1;
      p[nb][3] *= dp[nb][3] - dl1;
    }
    uint32_t dsa[kNB / 2][4];
    to_a_frags<kNB>(dsa, p);
    mma_cols<D, kNB, kBwdBK>(acc, dsa, s.kt, g, t);
  }

  __nv_bfloat16* o = dq + (static_cast<long long>(b) * a.lq * a.heads + h) * D;
  const long long row_stride = static_cast<long long>(a.heads) * D;
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
    const int c = db * 8 + 2 * t;
    if (r0 < a.lq)
      *reinterpret_cast<uint32_t*>(o + r0 * row_stride + c) =
          pack_bf16(acc[db][0] * a.scale, acc[db][1] * a.scale);
    if (r1 < a.lq)
      *reinterpret_cast<uint32_t*>(o + r1 * row_stride + c) =
          pack_bf16(acc[db][2] * a.scale, acc[db][3] * a.scale);
  }
  if (t == 0) {
    const long long base = (static_cast<long long>(b) * a.heads + h) * a.lq;
    if (r0 < a.lq) { lse_out[base + r0] = lse0; delta_out[base + r0] = dl0; }
    if (r1 < a.lq) { lse_out[base + r1] = lse1; delta_out[base + r1] = dl1; }
  }
}

// dK/dV kernel body: 64 keys at k0 of head (b, h).
template <int D>
__device__ __forceinline__ void attn_bwd_dkv_mma(const AttnArgs& a, int b, int h, int k0,
                                                 __nv_bfloat16* dk, __nv_bfloat16* dv,
                                                 const float* lse_in, const float* delta_in,
                                                 DkvMmaSmem<D>& s) {
  constexpr int kNB = kBwdBQ / 8;    // n-blocks of S^T per query tile
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t bh = b * a.heads + h;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.out) + b * a.o_sb + h * a.o_sh;
  const float* lse = lse_in + (static_cast<long long>(b) * a.heads + h) * a.lq;
  const float* delta = delta_in + (static_cast<long long>(b) * a.heads + h) * a.lq;
  const int j0 = k0 + warp * 16 + g, j1 = j0 + 8;     // this thread's two keys
  const float kb0 = j0 < a.lk ? a.bias[b * a.bias_sb + j0] : -INFINITY;
  const float kb1 = j1 < a.lk ? a.bias[b * a.bias_sb + j1] : -INFINITY;

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a_frags<D>(ka, k, a.k_sl, j0, a.lk, t);
  load_a_frags<D>(va, v, a.v_sl, j0, a.lk, t);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  for (int q0 = 0; q0 < a.lq; q0 += kBwdBQ) {
    __syncthreads();   // the previous query tile is consumed
    load_tile_bf16<kBwdBQ, D>(s.q, s.qt, q, a.q_sl, q0, a.lq);
    load_tile_bf16<kBwdBQ, D>(s.dout, s.dot, dout, a.o_sl, q0, a.lq);
    if (tid < kBwdBQ) {
      // queries past Lq: lse +inf gives P = 0, so they add nothing
      s.lse[tid] = q0 + tid < a.lq ? lse[q0 + tid] : INFINITY;
      s.delta[tid] = q0 + tid < a.lq ? delta[q0 + tid] : 0.f;
    }
    __syncthreads();

    float st[kNB][4], dpt[kNB][4];
    mma_rows<D, kNB>(st, ka, s.q, g, t);      // S^T = K Q^T   [key][q]
    mma_rows<D, kNB>(dpt, va, s.dout, g, t);  // dP^T = V dO^T [key][q]
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const int c = nb * 8 + 2 * t;           // query column within the tile
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = c + (e & 1), key = e < 2 ? j0 : j1;
        const float p = expf(st[nb][e] * a.scale + (e < 2 ? kb0 : kb1) - s.lse[qc]);
        const float f = mma_drop(a, bh, q0 + qc, key);
        st[nb][e] = p * f;                                  // P~^T
        dpt[nb][e] = p * (dpt[nb][e] * f - s.delta[qc]);    // dS^T
      }
    }
    uint32_t pa[kNB / 2][4], dsa[kNB / 2][4];
    to_a_frags<kNB>(pa, st);
    to_a_frags<kNB>(dsa, dpt);
    mma_cols<D, kNB, kBwdBQ>(dva, pa, s.dot, g, t);   // dV += P~^T dO
    mma_cols<D, kNB, kBwdBQ>(dka, dsa, s.qt, g, t);   // dK += dS^T Q
  }

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
