// Counter-based Philox4x32-10 (Salmon et al., "Parallel random numbers: as
// easy as 1, 2, 3", SC'11; the Random123 definition) for the attention
// kernels' dropout. It replaces the TPU's in-kernel PRNG
// (k3m_tpu/kernels/attention.py:_dropout_mask), whose bits it cannot
// reproduce.
//
// The mask is a pure function of (seed, b, h, q, k):
//   key     = (seed + salt, b * H + h)
//   counter = (k / 4, q, 0, 0), word k % 4 of the four outputs
//   keep    = (bits >> 8) >= keep_min, keep_min = ceil(rate * 2^24)
// which is `(bits >> 8) * 2^-24 >= rate` of the TPU kernel, evaluated
// exactly in integers; one Philox call gives the bits of four keys.
// k3m_tpu_torch/kernels/attention.py:philox_keep_mask_plain computes the
// same bits in torch int64 arithmetic. Only the forward kernels draw it.
// Where a backward follows, they store the mask they drew, one bit per
// element (bit k % 32 of word [b, h, q, k / 32]), and the backward reads
// those words.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace k3m {

// N Philox4x32-10 calls under one key, round by round, so that each round
// key is formed once for all N.
template <int N>
__device__ __forceinline__ void philox4x32_10_n(uint4 (&c)[N], uint2 key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const uint32_t hi0 = __umulhi(kM0, c[i].x), lo0 = kM0 * c[i].x;
      const uint32_t hi1 = __umulhi(kM1, c[i].z), lo1 = kM1 * c[i].z;
      c[i] = make_uint4(hi1 ^ c[i].y ^ key.x, lo1, hi0 ^ c[i].w ^ key.y, lo0);
    }
    key.x += kW0;
    key.y += kW1;
  }
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 key) {
  uint4 cs[1] = {c};
  philox4x32_10_n<1>(cs, key);
  return cs[0];
}

// The four random words of keys [4 * (k / 4), 4 * (k / 4) + 4) of query row q.
__device__ __forceinline__ uint4 dropout_bits(uint32_t seed, uint32_t bh, int q, int k) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(k) >> 2, static_cast<uint32_t>(q), 0u, 0u),
                       make_uint2(seed, bh));
}

// keep_min is below 2^24 (keep_threshold; the launchers check it), so
// (bits >> 8) >= keep_min is bits >= keep_min * 2^8, one compare a word.
constexpr uint32_t kKeepMinLimit = 1u << 24;

// Keep bits of the four words of one Philox call: bit i keeps word i.
__device__ __forceinline__ uint32_t keep_nibble(uint4 w, uint32_t keep_min) {
  const uint32_t thr = keep_min << 8;
  return static_cast<uint32_t>(w.x >= thr)
         | static_cast<uint32_t>(w.y >= thr) << 1
         | static_cast<uint32_t>(w.z >= thr) << 2
         | static_cast<uint32_t>(w.w >= thr) << 3;
}

// Keep bits of keys [k4, k4 + 4) of query row q (k4 a multiple of 4) from
// one Philox call: bit i is key k4 + i.
__device__ __forceinline__ uint32_t keep_bits4(uint32_t seed, uint32_t bh, int q, int k4,
                                               uint32_t keep_min) {
  return keep_nibble(dropout_bits(seed, bh, q, k4), keep_min);
}

// The keep bits of one tile of BK keys at k0 as the bf16 forward tile holds
// them (attention_mma.cuh), where the thread of column pair t holds keys
// k0 + 16 m + 4 t + [0, 4) of its rows r0 and r1 in each 16-key group m:
// bits 8 m + [0, 4) are those of row r0, bits 8 m + [4, 8) those of row
// r1. Stored as the mask's words: bit k % 32 of word [b, h, q, k / 32]
// keeps (q, k), `row_base` the index of row (b, h, 0). The 4 lanes of a row
// OR their nibbles together, and lane 0 (row r0) and lane 1 (row r1) store.
// The whole warp must call it.
template <int BK>
__device__ __forceinline__ void store_keep_words(uint32_t* words, uint32_t bits,
                                                 long long row_base, int r0, int r1, int k0,
                                                 int lq, int lk, int t) {
  const int nwords = (lk + 31) / 32;
#pragma unroll
  for (int w = 0; w < BK / 32; ++w) {
    const uint32_t lo = bits >> (16 * w), hi = bits >> (16 * w + 8);   // groups 2w, 2w + 1
    uint32_t w0 = (lo & 15u) << (4 * t) | (hi & 15u) << (16 + 4 * t);
    uint32_t w1 = (lo >> 4 & 15u) << (4 * t) | (hi >> 4 & 15u) << (16 + 4 * t);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      w0 |= __shfl_xor_sync(0xffffffffu, w0, off);
      w1 |= __shfl_xor_sync(0xffffffffu, w1, off);
    }
    const int word = k0 / 32 + w;
    if (word < nwords) {
      if (t == 0 && r0 < lq) words[(row_base + r0) * nwords + word] = w0;
      if (t == 1 && r1 < lq) words[(row_base + r1) * nwords + word] = w1;
    }
  }
}

}  // namespace k3m
