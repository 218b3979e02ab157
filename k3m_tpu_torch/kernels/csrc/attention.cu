// Fused multi-head self-attention forward: softmax(Q K^T / sqrt(D) + bias) V.
//
// Replaces: k3m_tpu/kernels/attention.py:_attn_kernel (called from
// _fused_attention_fwd_call), dropout on the probabilities included (the
// TPU PRNG becomes the Philox mask of philox.cuh). Its backward
// (_attn_bwd_kernel) is attention_bwd.cu.
//
// Bound on the H100: at the model's shapes (Lk <= 256, D 64/128) the
// arithmetic is small beside the card's tensor-core rate, and the least
// time is set by reading Q, K, V once and writing the context once. The
// design keeps the [Lq, Lk] score matrix out of device memory (online
// softmax over shared-memory K/V tiles) and reads the strided [B, L, H, D]
// projections in place. bf16 runs both products on the tensor cores
// (mma.sync, attention_mma.cuh); fp32 keeps scalar fp32 FMAs
// (attention.cuh), so that its result stays within fp32 rounding of the
// plain version.
#include "attention_mma.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(k3m::kAttnThreads) attn_fwd_kernel(k3m::AttnArgs a) {
  __shared__ k3m::AttnSmem<D> s;
  k3m::attn_tile<T, D>(a, blockIdx.z, blockIdx.y, blockIdx.x * k3m::kBQ, s);
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(k3m::kMmaThreads, k3m::fwd_min_blocks<D>())
attn_fwd_mma_kernel(k3m::AttnArgs a) {
  __shared__ k3m::MmaSmem<D> s;
  k3m::attn_tile_mma<D, kDrop>(a, blockIdx.z, blockIdx.y, blockIdx.x * k3m::kMmaBQ, s);
}

template <bool kDrop>
int launch_mma_drop(const k3m::AttnArgs& a, int B, int H, int d, cudaStream_t stream) {
  const dim3 grid((a.lq + k3m::kMmaBQ - 1) / k3m::kMmaBQ, H, B);
  switch (d) {
    case 64: attn_fwd_mma_kernel<64, kDrop><<<grid, k3m::kMmaThreads, 0, stream>>>(a); break;
    case 96: attn_fwd_mma_kernel<96, kDrop><<<grid, k3m::kMmaThreads, 0, stream>>>(a); break;
    case 128: attn_fwd_mma_kernel<128, kDrop><<<grid, k3m::kMmaThreads, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const k3m::AttnArgs& a, int B, int H, int d, cudaStream_t stream) {
  return a.keep_min ? launch_mma_drop<true>(a, B, H, d, stream)
                    : launch_mma_drop<false>(a, B, H, d, stream);
}

template <typename T>
int launch(const k3m::AttnArgs& a, int B, int H, int d, cudaStream_t stream) {
  const dim3 grid((a.lq + k3m::kBQ - 1) / k3m::kBQ, H, B);
  switch (d) {
    case 64: attn_fwd_kernel<T, 64><<<grid, k3m::kAttnThreads, 0, stream>>>(a); break;
    case 96: attn_fwd_kernel<T, 96><<<grid, k3m::kAttnThreads, 0, stream>>>(a); break;
    case 128: attn_fwd_kernel<T, 128><<<grid, k3m::kAttnThreads, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: [q_b, q_l, q_h, k_b, k_l, k_h, v_b, v_l, v_h, o_b, o_l, o_h, bias_b]
// in elements. `lse`: null, or fp32 [B, H, Lq] for each row's log-sum-exp;
// `keep_words`: null, or uint32 [B, H, Lq, ceil(Lk / 32)] for the dropout
// mask, one bit per element (both the backward's inputs). Returns
// cudaGetLastError() after the launch (0 on success).
// Dropout: keep iff (philox bits >> 8) >= keep_min (0: no dropout), kept
// probabilities scaled by keep_scale; see philox.cuh.
extern "C" int k3m_attention_fwd(const void* q, const void* k, const void* v,
                                 const float* bias, void* out, float* lse,
                                 uint32_t* keep_words, int dtype, int B,
                                 int H, int lq, int lk, int d,
                                 const long long* strides, float scale,
                                 unsigned seed, unsigned keep_min, float keep_scale,
                                 void* stream_ptr) {
  if (B <= 0 || H <= 0 || lq <= 0 || lk <= 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  k3m::AttnArgs a = k3m::make_args(q, k, v, bias, out, strides, lq, lk, H, scale,
                                   seed, keep_min, keep_scale);
  a.lse = lse;
  a.keep_words = keep_words;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == k3m::kF32) return launch<float>(a, B, H, d, stream);
  if (!k3m::mma_aligned(a)) return cudaErrorInvalidValue;
  return launch_mma(a, B, H, d, stream);
}
