// Tensor-core device code of one bf16 attention tile, shared by the
// self-attention kernel (attention.cu) and the co-attention kernel
// (coattn.cu). The fp32 kernels keep the scalar tile of attention.cuh.
//
// One CTA of 4 warps owns kMmaBQ = 64 query rows of one (batch, head), 16
// per warp, and streams the keys in tiles of kMmaBK = 64 through shared
// memory with an online softmax. Both products run on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate):
//   S = Q K^T : Q's A fragments are loaded once from device memory into
//               registers; K^T's B fragments are 32-bit shared loads of the
//               [key][d] tile (a "col" B operand is K row-major).
//   O += P V  : the fp32 S accumulators are exactly the A-fragment layout
//               of the next product, so P goes from registers to the tensor
//               cores after one bf16 rounding (as FlashAttention-2 does);
//               V is stored transposed, [d][key], so its B fragments are
//               32-bit loads too.
// The softmax statistics (running max m and sum l) stay fp32 and use the
// unrounded probabilities. Shared rows are padded by 8 bf16 so the 8 rows a
// fragment load touches fall in distinct banks. Keys past Lk score -inf and
// their K/V rows are zero; query rows past Lq run on zeros and are not
// stored. Operands need 16-byte aligned rows (strides multiples of 8
// elements), which the launchers and the Python wrappers check.
#pragma once

#include <math.h>
#include <stdint.h>

#include "attention.cuh"

namespace k3m {

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;   // query rows per CTA
constexpr int kMmaBK = 64;               // keys per shared tile
constexpr int kPad = 8;                  // bf16 padding per shared row

template <int D>
struct MmaSmem {
  __nv_bfloat16 k[kMmaBK][D + kPad];
  __nv_bfloat16 vt[D][kMmaBK + kPad];
  float bias[kMmaBK];
};

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// True when every row the tile reads or writes starts 16-byte aligned.
inline bool mma_aligned(const AttnArgs& a) {
  const long long st[] = {a.q_sb, a.q_sl, a.q_sh, a.k_sb, a.k_sl, a.k_sh,
                          a.v_sb, a.v_sl, a.v_sh, a.o_sb, a.o_sl, a.o_sh};
  for (long long s : st)
    if (s % 8) return false;
  const void* ptrs[] = {a.q, a.k, a.v, a.out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <int D>
__device__ __forceinline__ void attn_tile_mma(const AttnArgs& a, int b, int h,
                                              int q0, MmaSmem<D>& s) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kSteps = D / 16;     // k-steps of S = Q K^T
  constexpr int kDBlocks = D / 8;    // n-blocks of O
  constexpr int kVecs = D / 8;       // 16-byte vectors per row
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;   // fragment row group, column pair
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* bias = a.bias + b * a.bias_sb;

  // this thread's two query rows and its Q A-fragments
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < a.lq ? ld32(q + r0 * a.q_sl + c) : 0u;
    qa[kk][1] = r1 < a.lq ? ld32(q + r1 * a.q_sl + c) : 0u;
    qa[kk][2] = r0 < a.lq ? ld32(q + r0 * a.q_sl + c + 8) : 0u;
    qa[kk][3] = r1 < a.lq ? ld32(q + r1 * a.q_sl + c + 8) : 0u;
  }

  float o[kDBlocks][4];
#pragma unroll
  for (int i = 0; i < kDBlocks; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < a.lk; k0 += kMmaBK) {
    __syncthreads();  // the previous K/V tile is consumed
    // K: a warp reads whole rows (d fastest); V: a warp reads 32 keys of
    // one 8-column slice (key fastest), so its transposed stores hit one
    // shared row each and no bank twice
    for (int idx = tid; idx < kMmaBK * kVecs; idx += kMmaThreads) {
      const int j = idx / kVecs, d = (idx % kVecs) * 8, kj = k0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      if (kj < a.lk) kv = *reinterpret_cast<const uint4*>(k + kj * a.k_sl + d);
      *reinterpret_cast<uint4*>(&s.k[j][d]) = kv;
    }
    for (int idx = tid; idx < kMmaBK * kVecs; idx += kMmaThreads) {
      const int j = idx % kMmaBK, d = (idx / kMmaBK) * 8, kj = k0 + j;
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (kj < a.lk) vv = *reinterpret_cast<const uint4*>(v + kj * a.v_sl + d);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) s.vt[d + i][j] = ve[i];
    }
    if (tid < kMmaBK) s.bias[tid] = k0 + tid < a.lk ? bias[k0 + tid] : -INFINITY;
    __syncthreads();

    // S = Q K^T over this tile: 8 n-blocks of 8 keys
    float sc[kMmaBK / 8][4];
#pragma unroll
    for (int nb = 0; nb < kMmaBK / 8; ++nb) {
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const __nv_bfloat16* kr = &s.k[nb * 8 + g][kk * 16 + 2 * t];
        mma_bf16(sc[nb], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }
    // scale, key bias (-inf past Lk) and the rows' tile max
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < kMmaBK / 8; ++nb) {
      const int c = nb * 8 + 2 * t;
      sc[nb][0] = sc[nb][0] * a.scale + s.bias[c];
      sc[nb][1] = sc[nb][1] * a.scale + s.bias[c + 1];
      sc[nb][2] = sc[nb][2] * a.scale + s.bias[c];
      sc[nb][3] = sc[nb][3] * a.scale + s.bias[c + 1];
      t0 = fmaxf(t0, fmaxf(sc[nb][0], sc[nb][1]));
      t1 = fmaxf(t1, fmaxf(sc[nb][2], sc[nb][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {   // the 4 threads of a row
      t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, off));
      t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, off));
    }
    // every tile holds at least one real key, so the new maxima are finite
    const float mn0 = fmaxf(m0, t0), mn1 = fmaxf(m1, t1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
    uint32_t pa[kMmaBK / 16][4];   // P as A fragments, bf16
#pragma unroll
    for (int nb = 0; nb < kMmaBK / 8; ++nb) {
      const float p0 = expf(sc[nb][0] - mn0), p1 = expf(sc[nb][1] - mn0);
      const float p2 = expf(sc[nb][2] - mn1), p3 = expf(sc[nb][3] - mn1);
      s0 += p0 + p1;
      s1 += p2 + p3;
      pa[nb / 2][(nb % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    l0 = l0 * al0 + s0;
    l1 = l1 * al1 + s1;
#pragma unroll
    for (int db = 0; db < kDBlocks; ++db) {
      o[db][0] *= al0;
      o[db][1] *= al0;
      o[db][2] *= al1;
      o[db][3] *= al1;
    }
    // O += P V: 4 k-steps of 16 keys, kDBlocks n-blocks of 8 columns
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
#pragma unroll
      for (int db = 0; db < kDBlocks; ++db) {
        const __nv_bfloat16* vr = &s.vt[db * 8 + g][kk * 16 + 2 * t];
        mma_bf16(o[db], pa[kk], ld32(vr), ld32(vr + 8));
      }
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + b * a.o_sb + h * a.o_sh;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int db = 0; db < kDBlocks; ++db) {
    const int c = db * 8 + 2 * t;
    if (r0 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r0 * a.o_sl + c) =
          pack_bf16(o[db][0] * inv0, o[db][1] * inv0);
    if (r1 < a.lq)
      *reinterpret_cast<uint32_t*>(out + r1 * a.o_sl + c) =
          pack_bf16(o[db][2] * inv1, o[db][3] * inv1);
  }
}

}  // namespace k3m
