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
// (mma.sync, attention_mma.cuh: a cp.async ring of K/V tiles, ldmatrix
// fragments, base-2 softmax, the dropout mask drawn beside the products,
// dead rows and keys skipped), compiled with and without dropout; fp32
// keeps scalar fp32 FMAs (attention.cuh), so that its result stays within
// fp32 rounding of the plain version.
#include "attention_mma.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(k3m::kAttnThreads) attn_fwd_kernel(k3m::AttnArgs a) {
  __shared__ k3m::AttnSmem<D> s;
  k3m::attn_tile<T, D>(a, blockIdx.z, blockIdx.y, blockIdx.x * k3m::kBQ, s);
}

// DV: the width of v and the output, D but for the latent-attention
// instance (q.k 192, v 128)
template <int D, bool kDrop, int DV = D>
__global__ void __launch_bounds__(k3m::kMmaThreads, k3m::fwd_min_blocks<D>())
attn_fwd_mma_kernel(k3m::AttnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  k3m::attn_tile_mma<D, kDrop, DV>(a, blockIdx.z, blockIdx.y, blockIdx.x * k3m::kMmaBQ,
                                   *reinterpret_cast<k3m::FwdSmem<D, DV>*>(smem));
}

// The tile's shared memory is over the 48 KB a launch gets without asking
// (dynamically) at D 128: the kernel's limit is raised on the current
// device at every launch (cheap; nothing is cached).
template <int D, bool kDrop, int DV = D>
int launch_mma_d(const k3m::AttnArgs& a, int B, int H, cudaStream_t stream) {
  constexpr int bytes = sizeof(k3m::FwdSmem<D, DV>);
  const cudaError_t e = cudaFuncSetAttribute(attn_fwd_mma_kernel<D, kDrop, DV>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.lq + k3m::kMmaBQ - 1) / k3m::kMmaBQ, H, B);
  attn_fwd_mma_kernel<D, kDrop, DV><<<grid, k3m::kMmaThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDrop>
int launch_mma_drop(const k3m::AttnArgs& a, int B, int H, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_mma_d<64, kDrop>(a, B, H, stream);
    case 96: return launch_mma_d<96, kDrop>(a, B, H, stream);
    case 128: return launch_mma_d<128, kDrop>(a, B, H, stream);
    default: return cudaErrorInvalidValue;
  }
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
// probabilities scaled by keep_scale; see philox.cuh. `row0`: the global row
// of batch row 0 (data parallelism); `head0`, `heads_global`: the call's H
// heads are heads head0 .. head0 + H - 1 of the layer's heads_global (tensor
// parallelism); the mask's key word 1 is (row0 + b) * heads_global + head0 + h.
extern "C" int k3m_attention_fwd(const void* q, const void* k, const void* v,
                                 const float* bias, void* out, float* lse,
                                 uint32_t* keep_words, int dtype, int B,
                                 int H, int lq, int lk, int d,
                                 const long long* strides, float scale,
                                 unsigned seed, unsigned keep_min, float keep_scale,
                                 int row0, int head0, int heads_global, void* stream_ptr) {
  if (B <= 0 || H <= 0 || lq <= 0 || lk <= 0 || B > 65535 || H > 65535 ||
      keep_min >= k3m::kKeepMinLimit || row0 < 0 || head0 < 0 ||
      static_cast<long long>(head0) + H > heads_global ||
      (static_cast<long long>(row0) + B) * heads_global > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  k3m::AttnArgs a = k3m::make_args(q, k, v, bias, out, strides, lq, lk, H, scale,
                                   seed, keep_min, keep_scale);
  a.lse = lse;
  a.keep_words = keep_words;
  a.batch_row0 = row0;
  a.key_heads = heads_global;
  a.key_head0 = head0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == k3m::kF32) return launch<float>(a, B, H, d, stream);
  if (!k3m::mma_aligned(a)) return cudaErrorInvalidValue;
  return launch_mma(a, B, H, d, stream);
}

// The latent-attention instance: q and k `dk` wide, v and the output `dv`
// wide (192 and 128, DeepSeek-V2's MLA heads), bf16 only; otherwise the
// arguments of k3m_attention_fwd, `scale` the caller's (the softmax scale
// with YaRN's m^2 folded in).
extern "C" int k3m_attention_fwd_split(const void* q, const void* k, const void* v,
                                       const float* bias, void* out, float* lse,
                                       uint32_t* keep_words, int B, int H, int lq, int lk,
                                       int dk, int dv, const long long* strides, float scale,
                                       unsigned seed, unsigned keep_min, float keep_scale,
                                       int row0, int head0, int heads_global,
                                       void* stream_ptr) {
  if (B <= 0 || H <= 0 || lq <= 0 || lk <= 0 || B > 65535 || H > 65535 ||
      keep_min >= k3m::kKeepMinLimit || row0 < 0 || head0 < 0 ||
      static_cast<long long>(head0) + H > heads_global ||
      (static_cast<long long>(row0) + B) * heads_global > 0x7fffffffLL ||
      dk != 192 || dv != 128)
    return cudaErrorInvalidValue;
  k3m::AttnArgs a = k3m::make_args(q, k, v, bias, out, strides, lq, lk, H, scale,
                                   seed, keep_min, keep_scale);
  a.lse = lse;
  a.keep_words = keep_words;
  a.batch_row0 = row0;
  a.key_heads = heads_global;
  a.key_head0 = head0;
  if (!k3m::mma_aligned(a)) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return keep_min ? launch_mma_d<192, true, 128>(a, B, H, stream)
                  : launch_mma_d<192, false, 128>(a, B, H, stream);
}
