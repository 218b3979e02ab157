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

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ key.x, lo1, hi0 ^ c.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return c;
}

// The four random words of keys [4 * (k / 4), 4 * (k / 4) + 4) of query row q.
__device__ __forceinline__ uint4 dropout_bits(uint32_t seed, uint32_t bh, int q, int k) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(k) >> 2, static_cast<uint32_t>(q), 0u, 0u),
                       make_uint2(seed, bh));
}

// Keep bits of keys [k4, k4 + 4) of query row q (k4 a multiple of 4) from
// one Philox call: bit i is key k4 + i.
__device__ __forceinline__ uint32_t keep_bits4(uint32_t seed, uint32_t bh, int q, int k4,
                                               uint32_t keep_min) {
  const uint4 w = dropout_bits(seed, bh, q, k4);
  return static_cast<uint32_t>((w.x >> 8) >= keep_min)
         | static_cast<uint32_t>((w.y >> 8) >= keep_min) << 1
         | static_cast<uint32_t>((w.z >> 8) >= keep_min) << 2
         | static_cast<uint32_t>((w.w >> 8) >= keep_min) << 3;
}

// The mask of an mma.sync m16n8k16 accumulator whose rows are queries and
// whose columns are keys: the thread (g = lane / 4, t = lane % 4) holds
// rows r0 = g and r1 = g + 8 of the 16-row block, keys k8 + 2t and
// k8 + 2t + 1 of the 8-key block at k8; bit e is its element e (rows r0,
// r0, r1, r1). Lanes t and t ^ 1 hold keys k8 + 4 (t / 2) + [0, 4) of both
// rows between them: the even lane draws row r0's four words, the odd lane
// row r1's, and one shuffle swaps them, so one Philox call serves four
// elements. The whole warp must call it.
__device__ __forceinline__ uint32_t keep_bits_qk(uint32_t seed, uint32_t bh, int r0, int r1,
                                                 int k8, uint32_t keep_min, int t) {
  const bool odd = t & 1;
  const uint32_t mine = keep_bits4(seed, bh, odd ? r1 : r0, k8 + 4 * (t >> 1), keep_min);
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
  const uint32_t row0 = odd ? other : mine, row1 = odd ? mine : other;
  const int sh = odd ? 2 : 0;     // keys 2t, 2t + 1 within the group of 4
  return ((row0 >> sh) & 3u) | (((row1 >> sh) & 3u) << 2);
}

// The keep bits of one tile of BK keys at k0 (bit 4 nb + e is element e of
// n-block nb, as keep_bits_qk gives them) stored as the mask's words: bit
// k % 32 of word [b, h, q, k / 32] keeps (q, k), `row_base` the index of
// row (b, h, 0). Each lane has 2 keys of rows r0 and r1 in every n-block,
// the 4 lanes of a row OR theirs together, and lane 0 (row r0) and lane 1
// (row r1) store. The whole warp must call it.
template <int BK>
__device__ __forceinline__ void store_keep_words(uint32_t* words, uint32_t bits,
                                                 long long row_base, int r0, int r1, int k0,
                                                 int lq, int lk, int t) {
  const int nwords = (lk + 31) / 32;
#pragma unroll
  for (int w = 0; w < BK / 32; ++w) {
    uint32_t w0 = 0, w1 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t b4 = bits >> (4 * (4 * w + j));
      w0 |= (b4 & 3u) << (8 * j + 2 * t);
      w1 |= ((b4 >> 2) & 3u) << (8 * j + 2 * t);
    }
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
