// Tensor-core device code of one bf16 attention forward tile, shared by the
// self-attention kernel (attention.cu) and the co-attention kernel
// (coattn.cu). The fp32 kernels keep the scalar tile of attention.cuh.
//
// A CTA of 4 warps owns 64 query rows of one (batch, head), 16 per warp,
// and streams the keys in tiles of fwd_bk<D>() with an online softmax.
// What bounds it on the H100 at the model's shapes (L <= 256, D 64-128) is
// latency and instruction issue, not the tensor cores (4 B H Lq Lk D flops
// take a third of the byte time at L 256), and under dropout the integer
// work of the Philox mask. The design:
//   loads     Q is staged once into shared memory with cp.async (16-byte
//             rows); K, V and the key bias go through a two-stage cp.async
//             ring of row-major [key][D + 8] tiles, so tile j + 1 is in
//             flight while tile j computes (mma_util.cuh);
//   products  both on mma.sync.m16n8k16 (bf16 in, fp32 accumulate): S =
//             Q K^T with A and B fragments from ldmatrix, O += P V with P
//             from registers (the fp32 S accumulators are the A-fragment
//             layout after one bf16 rounding, as in FlashAttention-2) and
//             V's B fragments from ldmatrix.trans of the row-major tile;
//   softmax   base 2: x = s scale log2(e) + bias log2(e) is one FFMA, then
//             one MUFU.EX2 (ex2.approx.ftz: a probability below 2^-126 of
//             the row's largest is 0); the running max m and sum l stay fp32
//             and use the unrounded, undropped probabilities; the stored lse
//             is the natural-log m ln 2 + log l;
//   dropout   K, V and the bias are stored key-permuted in groups of 16
//             (perm16), so that the 4 accumulator columns a thread holds in a
//             group's two n-blocks are 4 consecutive keys: one Philox call
//             (keep_nibble) gives their mask in each of its rows, with no
//             exchange between lanes, and the calls of rows r0 and r1 run
//             round by round, drawn beside the tile's products. P V takes
//             the dropped probabilities and the output is scaled by
//             keep_scale / l at the end; a non-null a.keep_words receives
//             the mask, one bit per element (store_keep_words);
//   dead work a warp whose 16 rows all lie at or past Lq only loads and
//             waits; in the last tile, the n-blocks of S (and the k-steps of
//             P V) whose first key is at or past Lk are skipped and draw no
//             mask (keys past Lk in a live n-block score -inf, their K/V
//             rows are zero);
//   output    each warp writes its bf16 rows into its own Q rows in shared
//             memory and stores them as 16-byte rows.
// Key tiles are 64 keys at D 64 and 32 at D 96/128, where a smaller ring
// leaves room for three CTAs per SM. Operands need 16-byte aligned rows
// (strides multiples of 8 elements), which the launchers and the Python
// wrappers check.
#pragma once

#include <math.h>
#include <stdint.h>

#include "attention.cuh"
#include "mma_util.cuh"

namespace k3m {

constexpr float kLn2 = 0.6931471805599453f;

// keys per shared tile
template <int D>
constexpr int fwd_bk() { return D <= 64 ? 64 : 32; }

// CTAs per SM the forward kernels are compiled for: at D 64 the tile fits
// in 128 registers, so that 4 CTAs share an SM; at D 96 and 128 three
template <int D>
constexpr int fwd_min_blocks() { return D <= 64 ? 4 : 3; }

// D: the width of q and k; DV: that of v and the output (D but for the
// latent-attention instance, q.k 192 wide and v 128, whose output rows fit
// in the Q rows that stage them)
template <int D, int DV = D>
struct FwdSmem {
  static_assert(DV <= D, "the output is staged in the query rows");
  static constexpr int BK = fwd_bk<D>();
  __nv_bfloat16 q[kMmaBQ][D + kPad];     // the CTA's query rows; at the end each
                                         // warp's 16 rows take its output
  __nv_bfloat16 k[2][BK][D + kPad];      // the two stages of the key ring
  __nv_bfloat16 v[2][BK][DV + kPad];
  float bias[2][BK];
};

// 2^x on the MUFU unit; a result below 2^-126 is flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

// a compile-time flag passed to the tile's generic lambda
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// kDrop: compiled with dropout (a.keep_min 0 keeps every element); the
// copies without it carry none of its registers (the serving path). DV: the
// width of v and the output (FwdSmem)
template <int D, bool kDrop, int DV = D>
__device__ __forceinline__ void attn_tile_mma(const AttnArgs& a, int b, int h, int q0,
                                              FwdSmem<D, DV>& s) {
  static_assert(D % 16 == 0 && DV % 16 == 0, "head dims must be multiples of 16");
  constexpr int BK = FwdSmem<D, DV>::BK;
  constexpr int kNB = BK / 8;        // n-blocks of S per key tile
  constexpr int kDB = DV / 8;        // n-blocks of O
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;   // fragment row group, column pair
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* bias = a.bias + b * a.bias_sb;
  const int row0 = warp * 16;                 // the warp's first row in the CTA
  const int r0 = q0 + row0 + g, r1 = r0 + 8;  // this thread's two query rows
  const bool live = q0 + row0 < a.lq;         // warp-uniform
  const uint32_t bh = static_cast<uint32_t>(b * a.heads + h);
  const long long row_base = static_cast<long long>(bh) * a.lq;
  const uint32_t key_bh =
      static_cast<uint32_t>((a.batch_row0 + b) * a.key_heads + a.key_head0 + h);
  const float scale2 = a.scale * kLog2e;
  const int tiles = (a.lk + BK - 1) / BK;

  // stage st <- key tile at k0: K, V and the key bias, key-permuted in
  // groups of 16 (perm16), so that the 4 accumulator columns a thread holds
  // in a group's two n-blocks are 4 consecutive keys: one Philox call each
  // for its rows r0 and r1, no exchange between lanes
  auto issue = [&](int st, int k0) {
    cp_tile<BK, D, true>(s.k[st], k, a.k_sl, k0, a.lk);
    cp_tile<BK, DV, true>(s.v[st], v, a.v_sl, k0, a.lk);
    cp_row<BK, true>(s.bias[st], bias, k0, a.lk);
    cp_async_commit();
  };
  cp_tile<kMmaBQ, D>(s.q, q, a.q_sl, q0, a.lq);   // committed with stage 0
  issue(0, 0);

  float o[kDB][4];
#pragma unroll
  for (int i = 0; i < kDB; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;   // m in log2 units

  // n-blocks of the tile at k0 that hold a key below Lk (a prefix: n-block
  // 2 m + a of the permuted tile starts at key k0 + 16 m + 2 a)
  auto live_blocks = [&](int k0) {
    const int n = a.lk - k0;
    return n >= BK ? kNB : 2 * (n / 16) + (n % 16 > 2 ? 2 : n % 16 > 0 ? 1 : 0);
  };
  // the keep bits of the tile at k0 (store_keep_words' layout): keys
  // k0 + 16 m + 4 t + [0, 4) of rows r0 and r1, in the 16-key groups that
  // hold a live n-block; the two calls of a group run round by round
  auto draw = [&](int k0, int nlive) {
    uint32_t bits = 0;
#pragma unroll
    for (int m = 0; m < kNB / 2; ++m) {
      if (2 * m < nlive) {
        const uint32_t c4 = static_cast<uint32_t>(k0 / 4 + 4 * m + t);
        uint4 c[2] = {make_uint4(c4, static_cast<uint32_t>(r0), 0u, 0u),
                      make_uint4(c4, static_cast<uint32_t>(r1), 0u, 0u)};
        philox4x32_10_n<2>(c, make_uint2(a.seed, key_bh));
        bits |= (keep_nibble(c[0], a.keep_min) | keep_nibble(c[1], a.keep_min) << 4) << (8 * m);
      }
    }
    return bits;
  };

  // one key tile of this warp's 16 rows; kPart: the tile reaches past Lk.
  // The mask is drawn here, in the same block as the products, so that the
  // Philox chains issue beside them
  auto step = [&](int st, int k0, auto part) {
    constexpr bool kPart = decltype(part)::value;
    const int nlive = kPart ? live_blocks(k0) : kNB;
    const uint32_t bits = kDrop ? draw(k0, nlive) : 0u;
    float sc[kNB][4];
    mma_over_d<D, kNB>(sc, s.q, row0, s.k[st], lane, nlive);   // S = Q K^T

    // base-2 scores and the rows' tile max
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      if (kPart && nb >= nlive) continue;
      const int c = nb * 8 + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(&s.bias[st][c]);
      float b0 = bb.x * kLog2e, b1 = bb.y * kLog2e;
      if (kPart) {   // column 2 t + e of n-block 2 m + a is key 16 m + 4 t + 2 a + e
        const int key = k0 + 16 * (nb / 2) + 4 * t + 2 * (nb % 2);
        if (key >= a.lk) b0 = -INFINITY;
        if (key + 1 >= a.lk) b1 = -INFINITY;
      }
      sc[nb][0] = fmaf(sc[nb][0], scale2, b0);
      sc[nb][1] = fmaf(sc[nb][1], scale2, b1);
      sc[nb][2] = fmaf(sc[nb][2], scale2, b0);
      sc[nb][3] = fmaf(sc[nb][3], scale2, b1);
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
    const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
    uint32_t pa[kNB / 2][4];   // P as A fragments, bf16
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      uint32_t& lo = pa[nb / 2][(nb % 2) * 2 + 0];
      uint32_t& hi = pa[nb / 2][(nb % 2) * 2 + 1];
      if (kPart && nb >= nlive) {
        lo = hi = 0u;
        continue;
      }
      const float p0 = ex2(sc[nb][0] - mn0), p1 = ex2(sc[nb][1] - mn0);
      const float p2 = ex2(sc[nb][2] - mn1), p3 = ex2(sc[nb][3] - mn1);
      s0 += p0 + p1;
      s1 += p2 + p3;
      if (kDrop) {   // row r0's keys at bits 8 m + 2 a + [0, 2), row r1's 4 above
        const uint32_t kb = bits >> (8 * (nb / 2) + 2 * (nb % 2));
        lo = pack_bf16(kb & 1u ? p0 : 0.f, kb & 2u ? p1 : 0.f);
        hi = pack_bf16(kb & 16u ? p2 : 0.f, kb & 32u ? p3 : 0.f);
      } else {
        lo = pack_bf16(p0, p1);
        hi = pack_bf16(p2, p3);
      }
    }
    if (kDrop && a.keep_words != nullptr)
      store_keep_words<BK>(a.keep_words, bits, row_base, r0, r1, k0, a.lq, a.lk, t);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    l0 = l0 * al0 + s0;
    l1 = l1 * al1 + s1;
#pragma unroll
    for (int db = 0; db < kDB; ++db) {
      o[db][0] *= al0;
      o[db][1] *= al0;
      o[db][2] *= al1;
      o[db][3] *= al1;
    }
    mma_over_rows<DV, kNB>(o, pa, s.v[st], lane, nlive);   // O += P V
  };

  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1, k0 = it * BK;
    if (it + 1 < tiles) {
      issue(st ^ 1, k0 + BK);   // that stage was consumed before the last barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      if (k0 + BK <= a.lk)
        step(st, k0, Flag<false>{});
      else
        step(st, k0, Flag<true>{});
    }
    __syncthreads();   // stage st is consumed
  }
  if (!live) return;

  // the output through this warp's own Q rows (no other warp reads them)
  __nv_bfloat16(*stage)[D + kPad] = s.q + row0;
  __syncwarp();
  const float ks = kDrop ? a.keep_scale : 1.f;
  const float inv0 = ks / l0, inv1 = ks / l1;
#pragma unroll
  for (int db = 0; db < kDB; ++db) {
    const int c = db * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(&stage[g][c]) = pack_bf16(o[db][0] * inv0, o[db][1] * inv0);
    *reinterpret_cast<uint32_t*>(&stage[g + 8][c]) = pack_bf16(o[db][2] * inv1, o[db][3] * inv1);
  }
  __syncwarp();
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = lane; i < 16 * kDB; i += 32) {
    const int rr = i / kDB, d = (i % kDB) * 8, r = q0 + row0 + rr;
    if (r < a.lq)
      *reinterpret_cast<uint4*>(out + r * a.o_sl + d) =
          *reinterpret_cast<const uint4*>(&stage[rr][d]);
  }
  if (a.lse != nullptr && t == 0) {
    if (r0 < a.lq) a.lse[row_base + r0] = m0 * kLn2 + logf(l0);
    if (r1 < a.lq) a.lse[row_base + r1] = m1 * kLn2 + logf(l1);
  }
}

}  // namespace k3m
