// Counter-based Philox4x32-10 (Salmon et al., "Parallel random numbers: as
// easy as 1, 2, 3", SC'11; the Random123 definition) for the attention
// kernels' dropout. It replaces the TPU's in-kernel PRNG
// (k3m_tpu/kernels/attention.py:_dropout_mask), whose bits it cannot
// reproduce.
//
// The mask is a pure function of (seed, b, h, q, k), so the forward and both
// backward kernels regenerate the same mask without storing it:
//   key     = (seed + salt, b * H + h)
//   counter = (k / 4, q, 0, 0), word k % 4 of the four outputs
//   keep    = (bits >> 8) >= keep_min, keep_min = ceil(rate * 2^24)
// which is `(bits >> 8) * 2^-24 >= rate` of the TPU kernel, evaluated
// exactly in integers. k3m_tpu_torch/kernels/attention.py:
// philox_keep_mask_plain computes the same bits in torch int64 arithmetic.
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

__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

// 1 if element (q, k) is kept, else 0.
__device__ __forceinline__ float keep(uint32_t seed, uint32_t bh, int q, int k,
                                      uint32_t keep_min) {
  const uint32_t bits = word(dropout_bits(seed, bh, q, k), k & 3);
  return (bits >> 8) >= keep_min ? 1.f : 0.f;
}

}  // namespace k3m
