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
// Design: both directions share one launch. In bf16 a one-dimensional grid
// holds every 64-row query tile of both directions, those of the direction
// with the longer key walk first (at 37<->256, the 37 queries over 256 keys:
// each of their CTAs walks 4 key tiles, the other direction's one), and
// each CTA runs the self-attention kernel's tensor-core tile
// (attention_mma.cuh), which skips the warps of padding rows (Lq 37, 50)
// and the n-blocks past Lk. fp32 runs the scalar tile of attention.cuh over
// a grid of (query tile of either direction, head, batch).
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

// The two directions of one launch. dir[0], whose CTAs walk more key
// tiles, takes the lower block indices, so its CTAs start first and the
// short ones fill the tail; ctas0 = B H ceil(Lq0 / 64) of them.
struct BiDirs {
  k3m::AttnArgs dir[2];
  int ctas0;
};

// A CTA of 4 warps serves 64 query rows of either direction; a warp of
// padding rows only loads and waits (at Lq 37 the fourth, so that 37 rows
// compute as 48). The parameter is __grid_constant__, so that the direction
// is picked by index without a local copy and the tile is inlined once.
// At D 64 (not a shape of the model) it compiles for 3 CTAs per SM: under
// the 128-register cap of 4 the direction's parameters would spill.
template <int D, bool kDrop>
__global__ void __launch_bounds__(k3m::kMmaThreads, D <= 64 ? 3 : k3m::fwd_min_blocks<D>())
biattn_fwd_mma_kernel(const __grid_constant__ BiDirs dirs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int second = static_cast<int>(blockIdx.x) >= dirs.ctas0;
  const k3m::AttnArgs& a = dirs.dir[second];
  const int i = static_cast<int>(blockIdx.x) - (second ? dirs.ctas0 : 0);
  const int tiles = (a.lq + k3m::kMmaBQ - 1) / k3m::kMmaBQ;
  const int bh = i / tiles;
  k3m::attn_tile_mma<D, kDrop>(a, bh / a.heads, bh % a.heads, (i % tiles) * k3m::kMmaBQ,
                               *reinterpret_cast<k3m::FwdSmem<D>*>(smem));
}

// Shared memory is raised past the 48 KB default at every launch, as in
// attention.cu.
template <int D, bool kDrop>
int launch_mma_d(const BiDirs& dirs, int B, int H, cudaStream_t stream) {
  constexpr int bytes = sizeof(k3m::FwdSmem<D>);
  const cudaError_t e = cudaFuncSetAttribute(biattn_fwd_mma_kernel<D, kDrop>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long ctas = static_cast<long long>(B) * H *
                         ((dirs.dir[0].lq + k3m::kMmaBQ - 1) / k3m::kMmaBQ +
                          (dirs.dir[1].lq + k3m::kMmaBQ - 1) / k3m::kMmaBQ);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  biattn_fwd_mma_kernel<D, kDrop><<<static_cast<unsigned>(ctas), k3m::kMmaThreads, bytes,
                                    stream>>>(dirs);
  return static_cast<int>(cudaGetLastError());
}

// The copy compiled with dropout where either direction drops, else the
// one without (the serving path).
template <bool kDrop>
int launch_mma_drop(const BiDirs& dirs, int B, int H, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_mma_d<64, kDrop>(dirs, B, H, stream);
    case 96: return launch_mma_d<96, kDrop>(dirs, B, H, stream);
    case 128: return launch_mma_d<128, kDrop>(dirs, B, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

int launch_mma(const k3m::AttnArgs& dir1, const k3m::AttnArgs& dir2, int B, int H,
               int d, cudaStream_t stream) {
  BiDirs dirs;
  const bool swap = dir2.lk > dir1.lk;   // the longer key walk first
  dirs.dir[0] = swap ? dir2 : dir1;
  dirs.dir[1] = swap ? dir1 : dir2;
  dirs.ctas0 = B * H * ((dirs.dir[0].lq + k3m::kMmaBQ - 1) / k3m::kMmaBQ);
  return dir1.keep_min || dir2.keep_min ? launch_mma_drop<true>(dirs, B, H, d, stream)
                                        : launch_mma_drop<false>(dirs, B, H, d, stream);
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
// keep_scale1/2 are the two directions' dropout (0: none); both key their
// masks by the global row and head ((row0 + b) * heads_global + head0 + h,
// attention.cu). Returns
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
                                   int row0, int head0, int heads_global,
                                   void* stream_ptr) {
  if (B <= 0 || H <= 0 || l1 <= 0 || l2 <= 0 || B > 65535 || H > 65535 ||
      keep_min1 >= k3m::kKeepMinLimit || keep_min2 >= k3m::kKeepMinLimit || row0 < 0 ||
      head0 < 0 || static_cast<long long>(head0) + H > heads_global ||
      (static_cast<long long>(row0) + B) * heads_global > 0x7fffffffLL)
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
  dir1.batch_row0 = dir2.batch_row0 = row0;
  dir1.key_heads = dir2.key_heads = heads_global;
  dir1.key_head0 = dir2.key_head0 = head0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == k3m::kF32) return launch<float>(dir1, dir2, B, H, d, stream);
  if (!k3m::mma_aligned(dir1) || !k3m::mma_aligned(dir2)) return cudaErrorInvalidValue;
  return launch_mma(dir1, dir2, B, H, d, stream);
}
