// Fused bi-directional co-attention forward, both directions in one launch:
//   ctx1 = softmax(Q2 K1^T / sqrt(D) + bias1) V1   [B, L2, H, D]
//   ctx2 = softmax(Q1 K2^T / sqrt(D) + bias2) V2   [B, L1, H, D]
//
// Replaces: k3m_tpu/kernels/coattn.py:_biattn_kernel (called from
// _fused_biattention_call), with its dropout: direction 1 draws its Philox
// mask from seed + 0, direction 2 from seed + 7919, the TPU kernel's salts.
// Its backward is the attention backward (attention_bwd.cu) once per
// direction, with the same seeds (coattn.py:178-192).
//
// Bound on the H100: like the self-attention kernel, reading the six
// projections once and writing both contexts once; the arithmetic is small.
// Design: one grid over (query tile of either direction, head, batch); the
// first ceil(L2/16) tiles along x serve direction 1, the rest direction 2,
// so both directions share one launch and one wave of CTAs. Each CTA runs
// the same device code as the self-attention kernel: the tensor-core tile
// of attention_mma.cuh in bf16, the scalar tile of attention.cuh in fp32.
// The head dim is a template parameter, so D = 96 (c_layer_pv_t: 8 heads
// over 768) needs no padding to a power of two.
#include "attention_mma.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(k3m::kAttnThreads)
biattn_fwd_kernel(k3m::AttnArgs dir1, k3m::AttnArgs dir2, int tiles1) {
  __shared__ k3m::AttnSmem<D> s;
  const int t = blockIdx.x;
  if (t < tiles1)
    k3m::attn_tile<T, D>(dir1, blockIdx.z, blockIdx.y, t * k3m::kBQ, s);
  else
    k3m::attn_tile<T, D>(dir2, blockIdx.z, blockIdx.y, (t - tiles1) * k3m::kBQ, s);
}

// One instantiation, dropout compiled in (the tile applies it where
// keep_min is set): without it the two inlined directions measured slower
// at D 96 and 128, while the self-attention kernel gained
template <int D>
__global__ void __launch_bounds__(k3m::kMmaThreads, k3m::fwd_min_blocks<D>())
biattn_fwd_mma_kernel(k3m::AttnArgs dir1, k3m::AttnArgs dir2, int tiles1) {
  __shared__ k3m::MmaSmem<D> s;
  const int t = blockIdx.x;
  if (t < tiles1)
    k3m::attn_tile_mma<D, true>(dir1, blockIdx.z, blockIdx.y, t * k3m::kMmaBQ, s);
  else
    k3m::attn_tile_mma<D, true>(dir2, blockIdx.z, blockIdx.y, (t - tiles1) * k3m::kMmaBQ, s);
}

int launch_mma(const k3m::AttnArgs& dir1, const k3m::AttnArgs& dir2, int B, int H,
               int d, cudaStream_t stream) {
  const int tiles1 = (dir1.lq + k3m::kMmaBQ - 1) / k3m::kMmaBQ;
  const int tiles2 = (dir2.lq + k3m::kMmaBQ - 1) / k3m::kMmaBQ;
  const dim3 grid(tiles1 + tiles2, H, B);
  switch (d) {
    case 64: biattn_fwd_mma_kernel<64><<<grid, k3m::kMmaThreads, 0, stream>>>(dir1, dir2, tiles1); break;
    case 96: biattn_fwd_mma_kernel<96><<<grid, k3m::kMmaThreads, 0, stream>>>(dir1, dir2, tiles1); break;
    case 128: biattn_fwd_mma_kernel<128><<<grid, k3m::kMmaThreads, 0, stream>>>(dir1, dir2, tiles1); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const k3m::AttnArgs& dir1, const k3m::AttnArgs& dir2, int B, int H,
           int d, cudaStream_t stream) {
  const int tiles1 = (dir1.lq + k3m::kBQ - 1) / k3m::kBQ;
  const int tiles2 = (dir2.lq + k3m::kBQ - 1) / k3m::kBQ;
  const dim3 grid(tiles1 + tiles2, H, B);
  switch (d) {
    case 64: biattn_fwd_kernel<T, 64><<<grid, k3m::kAttnThreads, 0, stream>>>(dir1, dir2, tiles1); break;
    case 96: biattn_fwd_kernel<T, 96><<<grid, k3m::kAttnThreads, 0, stream>>>(dir1, dir2, tiles1); break;
    case 128: biattn_fwd_kernel<T, 128><<<grid, k3m::kAttnThreads, 0, stream>>>(dir1, dir2, tiles1); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides (elements): [q1 b,l,h, k1 b,l,h, v1 b,l,h, q2 b,l,h, k2 b,l,h,
// v2 b,l,h, out1 b,l,h, out2 b,l,h, bias1_b, bias2_b]. lse1 [B, H, L2] and
// lse2 [B, H, L1]: null, or the rows' log-sum-exp out; words1 [B, H, L2,
// ceil(L1 / 32)] and words2 [B, H, L1, ceil(L2 / 32)]: null, or the two
// directions' dropout masks out, one bit per element. keep_min1/2 and
// keep_scale1/2 are the two directions' dropout (0: none). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int k3m_biattention_fwd(const void* q1, const void* k1, const void* v1,
                                   const float* bias1, const void* q2,
                                   const void* k2, const void* v2,
                                   const float* bias2, void* out1, void* out2,
                                   float* lse1, float* lse2, uint32_t* words1,
                                   uint32_t* words2, int dtype, int B,
                                   int H, int l1, int l2, int d,
                                   const long long* st, float scale, unsigned seed,
                                   unsigned keep_min1, float keep_scale1,
                                   unsigned keep_min2, float keep_scale2,
                                   void* stream_ptr) {
  if (B <= 0 || H <= 0 || l1 <= 0 || l2 <= 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  // direction 1: stream-2 queries over stream-1 keys/values, bias1
  const long long s1[13] = {st[9], st[10], st[11], st[3], st[4], st[5],
                            st[6], st[7], st[8], st[18], st[19], st[20], st[24]};
  // direction 2: stream-1 queries over stream-2 keys/values, bias2
  const long long s2[13] = {st[0], st[1], st[2], st[12], st[13], st[14],
                            st[15], st[16], st[17], st[21], st[22], st[23], st[25]};
  k3m::AttnArgs dir1 = k3m::make_args(q2, k1, v1, bias1, out1, s1, l2, l1, H, scale,
                                      seed, keep_min1, keep_scale1);
  k3m::AttnArgs dir2 = k3m::make_args(q1, k2, v2, bias2, out2, s2, l1, l2, H, scale,
                                      seed + 7919u, keep_min2, keep_scale2);
  dir1.lse = lse1;
  dir2.lse = lse2;
  dir1.keep_words = words1;
  dir2.keep_words = words2;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == k3m::kF32) return launch<float>(dir1, dir2, B, H, d, stream);
  if (!k3m::mma_aligned(dir1) || !k3m::mma_aligned(dir2)) return cudaErrorInvalidValue;
  return launch_mma(dir1, dir2, B, H, d, stream);
}
