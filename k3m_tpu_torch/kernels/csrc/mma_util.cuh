// Building blocks of the bf16 tensor-core attention tiles, shared by the
// forward (attention_mma.cuh) and the backward (attention_bwd_mma.cuh):
// mma.sync on bf16 fragments, cp.async copies into padded row-major shared
// tiles, and ldmatrix fragment loads, plain and transposed, from them.
//
// Every operand lives in shared memory as one row-major [row][d] tile whose
// rows are padded by kPad bf16 (16 bytes), so that the 8 rows an ldmatrix
// reads fall in 8 distinct bank groups, for the plain and the transposed
// read alike. A products over d (S = Q K^T) take their A and B fragments
// from ldmatrix; products over the rows (O += P V) their B fragments from
// ldmatrix.trans of the same tile, so nothing is stored transposed.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace k3m {

constexpr int kMmaWarps = 4;             // warps of a 64-row CTA
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;   // rows per 64-row CTA, 16 per warp
constexpr int kPad = 8;                  // bf16 padding per shared row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

// The shared row of row j of a tile stored key-permuted in groups of 16
// (the forward tile, attention_mma.cuh): row 16 m + 4 t + 2 a + b goes to
// 16 m + 8 a + 2 t + b, so that the mma.sync accumulator columns a thread
// holds in the group's two n-blocks are 4 consecutive rows.
__device__ __forceinline__ int perm16(int j) {
  const int u = j & 15;
  return (j & ~15) | ((u >> 1) & 1) << 3 | (u >> 2) << 1 | (u & 1);
}

// rows [r0, r0 + ROWS) of a [L, D] bf16 operand into `dst` [row][d] with
// cp.async by the CTA (not yet committed); zeros past `n`; kPerm: row j to
// shared row perm16(j)
template <int ROWS, int D, bool kPerm = false>
__device__ __forceinline__ void cp_tile(__nv_bfloat16 (*dst)[D + kPad], const __nv_bfloat16* base,
                                        long long sl, int r0, int n) {
  constexpr int kVecs = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * kVecs; idx += kMmaThreads) {
    const int j = idx / kVecs, d = (idx % kVecs) * 8, r = r0 + j;
    const bool ok = r < n;
    cp_async16(&dst[kPerm ? perm16(j) : j][d], base + (ok ? r : 0) * sl + d, ok);
  }
}

// elements [i0, i0 + N) of an fp32 row into `dst` with cp.async by the CTA
// (not yet committed); zeros past `n`; kPerm: element i to perm16(i)
template <int N, bool kPerm = false>
__device__ __forceinline__ void cp_row(float* dst, const float* src, int i0, int n) {
  for (int i = threadIdx.x; i < N; i += kMmaThreads) {
    const bool ok = i0 + i < n;
    cp_async4(dst + (kPerm ? perm16(i) : i), src + (ok ? i0 + i : 0), ok);
  }
}

// acc[NB][4] = A (16 rows [a0, a0 + 16) of `at` [row][d]) times B,
// B[d][n] = bt[n][d] for the NB * 8 rows of `bt`: a product over d
// (S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T). Only the first
// `nb_live` n-blocks are computed (warp-uniform; the rest stay zero).
template <int D, int NB>
__device__ __forceinline__ void mma_over_d(float (&acc)[NB][4], const __nv_bfloat16 (*at)[D + kPad],
                                           int a0, const __nv_bfloat16 (*bt)[D + kPad], int lane,
                                           int nb_live = NB) {
  const int row = (lane & 7) + ((lane >> 4) << 3), col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4];
    ldsm4(fa, &at[a0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      if (2 * np < nb_live) {
        uint32_t b[4];
        ldsm4(b, &bt[np * 16 + row][kk * 16 + col]);
        mma_bf16(acc[2 * np], fa, b[0], b[1]);
        if (2 * np + 1 < nb_live) mma_bf16(acc[2 * np + 1], fa, b[2], b[3]);
      }
    }
  }
}

// acc[D/8][4] += A (16 x 8*NB, fragments fa) times the rows of `bt`
// ([8*NB][D] row-major: B[row][d], a product over the rows), B fragments
// from ldmatrix.trans. Only the k-steps of 16 rows that hold one of the
// first `nb_live` 8-row blocks run (warp-uniform).
template <int D, int NB>
__device__ __forceinline__ void mma_over_rows(float (&acc)[D / 8][4],
                                              const uint32_t (&fa)[NB / 2][4],
                                              const __nv_bfloat16 (*bt)[D + kPad], int lane,
                                              int nb_live = NB) {
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    if (2 * kk < nb_live) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldsm4_t(b, &bt[kk * 16 + row][dp * 16 + col]);
        mma_bf16(acc[2 * dp], fa[kk], b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], fa[kk], b[2], b[3]);
      }
    }
  }
}

}  // namespace k3m
