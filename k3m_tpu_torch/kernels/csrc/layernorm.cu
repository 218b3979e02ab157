// Fused (residual add +) LayerNorm, forward and backward.
//
// Replaces: k3m_tpu/kernels/layernorm.py:_ln_fwd_kernel (called from
// _fwd_call) and _ln_bwd_kernel (called from _bwd_call).
//
// Forward: y = LN(x [+ res]) * scale + bias over the last axis, TF style
// (eps inside the rsqrt), two-pass fp32 mean and centered variance, cast to
// the output dtype in the kernel; with a non-null `rstd` it also writes the
// row's fp32 1/sqrt(var + eps), which the backward needs.
//
// Backward, from the saved output and rstd only (never the inputs), as the
// TPU kernel does: xhat = (y - bias) / safe(scale) with |scale| < 1e-6 read
// as 1e-6; g = dy * scale; dx = rstd * (g - mean(g) - xhat * mean(g * xhat));
// dscale = sum over rows of dy * xhat; dbias = sum over rows of dy.
//
// Bound on the H100: device-memory bytes. Each element is read once (x, and
// res when given; y and dy in the backward) and written once, with ~10-16
// flops per element, far below the card's flop/byte balance.
//
// Forward design. What bounds it is device-memory bytes: ~6 bytes an
// element in bf16 with a residual against ~10 flops, so the card must keep
// ~25 KB in flight per SM (3.35 TB/s x ~1 us of latency over 132 SMs) and
// move them in few, wide loads and stores. Two instances:
// - The vector instance (ln_fwd_vec_kernel) takes rows of a multiple of 8
//   columns whose tensors start on 16-byte boundaries: every shape of the
//   main path. A warp owns a row at a time; lane l owns the column groups
//   l, l + 32, ... (8 columns where every tensor is bf16, else 4, so that
//   each warp load or store is one contiguous run of 16- or 8-byte
//   vectors), templated on the groups per lane, so at 768 and 1024 columns
//   no loop carries a predicate, and keeps those columns' scale and bias in
//   registers for the whole kernel. The grid is persistent (the SMs times
//   the blocks an SM holds, from the occupancy query; two such waves where
//   each warp would take more than 4 rows, so that the last rows go to
//   whichever blocks are free) and warp w of it takes rows w, w + warps,
//   ..., loading the next row into registers while it reduces and stores
//   this one (the backward's pattern; up to 255 registers, so the
//   1024-column rows do not spill). A design that brought the rows into
//   per-warp rings of shared memory by Hopper's bulk asynchronous copy
//   (cp.async.bulk completing on mbarriers, ~100-190 KB in flight per SM)
//   was no faster at the main-path shapes and was dropped (PERF.md).
// - The per-element instance (ln_fwd_kernel, the first design) takes
//   every other shape: any width up to 1024 and any element alignment, one
//   warp per row, lane l on columns l, l + 32, ...
// The wrapper picks the instance (kernels/layernorm.py ln_instance). Each
// row is computed by one warp in a fixed order in both, so the same input
// gives the same bits whatever the grid. Rows of 1,025 to 2,048 columns
// (the DeepSeek-V2 text block's 2048-wide text in the co-attention and the
// heads) take the vector instance only: its kernel for them
// (ln_fwd_wide_kernel) keeps a row's 64 values a lane in registers but not
// scale and bias, which it reads per group as it stores the row (they stay
// in L1), and launches a warp per row with no prefetch, the occupancy
// keeping the loads in flight.
//
// Backward design. The TPU sums dscale/dbias across its sequential grid in
// VMEM; blocks on the card run in no order, so the rows are cut into bands,
// one per block of 8 warps, and the grid is two waves of the card's SMs
// (bands_for). A warp takes one row at a time and loads the next one while
// it computes, with 16-byte loads: lane l owns the 16-byte column vectors
// l, l + 32, ... of every row of its band, so it keeps those columns' scale,
// bias, 1 / safe(scale) and its dscale/dbias sums in registers for the
// whole band and the row's data never goes through shared memory. At the
// end the block adds its 8 warps in a fixed order and writes fp32 partials
// [bands, N]; a second kernel, parallel over columns, adds the partials in
// band order. No atomics: the parameter gradients are the same in every
// run. The backward takes widths that are whole 16-byte vectors (N a
// multiple of 8 in bf16, of 4 in fp32). Rows of 1,025 to 2,048 columns
// (ln_bwd_wide_kernel) would not keep a lane's scale, bias, 1 / safe(scale)
// and sums in registers, so those live in dynamic shared memory (152 KB at
// 2,048 columns, one block an SM), column E vi + e of a lane's vector vi at
// word e nv + vi, so that a warp's lanes read consecutive words; each warp
// sums its rows into its own words, and a lane keeps its row's xhat and g
// in registers between the two passes. The partials and their reduction
// are the narrow kernel's.
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // rows in flight per CTA of the per-element instance
constexpr int kMaxPerLane = 32;    // N <= 32 * 32
constexpr int kMaxN = 32 * kMaxPerLane;
constexpr int kMaxWideN = 2048;    // the vector instance's and the backward's widest rows

template <typename TX, typename TR, typename TO, bool kRes>
__global__ void __launch_bounds__(kWarps * 32)
ln_fwd_kernel(const TX* __restrict__ x, const TR* __restrict__ res,
              const float* __restrict__ scale, const float* __restrict__ bias,
              TO* __restrict__ out, float* __restrict__ rstd_out, int rows, int n,
              float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const size_t base = static_cast<size_t>(row) * n;
  float v[kMaxPerLane];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    float t = 0.f;
    if (c < n) {
      t = k3m::to_f32(x[base + c]);
      if (kRes) t += k3m::to_f32(res[base + c]);
    }
    v[i] = t;
    sum += t;
  }
  const float mean = k3m::warp_sum(sum) / n;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    const float d = c < n ? v[i] - mean : 0.f;
    v[i] = d;
    sq += d * d;
  }
  const float rstd = rsqrtf(k3m::warp_sum(sq) / n + eps);
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < n) out[base + c] = k3m::from_f32<TO>(v[i] * rstd * scale[c] + bias[c]);
  }
  if (rstd_out != nullptr && lane == 0) rstd_out[row] = rstd;
}

template <typename TX, typename TR, typename TO, bool kRes>
void launch_elem(const void* x, const void* res, const void* scale, const void* bias,
            void* out, float* rstd, int rows, int n, float eps, cudaStream_t stream) {
  const int grid = (rows + kWarps - 1) / kWarps;
  ln_fwd_kernel<TX, TR, TO, kRes><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TR*>(res),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<TO*>(out), rstd, rows, n, eps);
}

template <typename TX, typename TO>
void launch_elem_res(const void* x, const void* res, int res_dtype, const void* scale,
                     const void* bias, void* out, float* rstd, int rows, int n, float eps,
                     cudaStream_t stream) {
  if (res == nullptr)
    launch_elem<TX, float, TO, false>(x, res, scale, bias, out, rstd, rows, n, eps, stream);
  else if (res_dtype == k3m::kF32)
    launch_elem<TX, float, TO, true>(x, res, scale, bias, out, rstd, rows, n, eps, stream);
  else
    launch_elem<TX, __nv_bfloat16, TO, true>(x, res, scale, bias, out, rstd, rows, n, eps,
                                             stream);
}

constexpr int kBwdWarps = 8;       // rows in flight per block of the backward

template <typename T>
struct VecOf {
  static constexpr int kElems = 16 / sizeof(T);   // elements per 16-byte vector
};

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// E values at p (E / 2 bf16 pairs or E floats, 8- or 16-byte aligned)
template <int E>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[E]) {
  if constexpr (E == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                                              pack2(f[4], f[5]), pack2(f[6], f[7]));
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(f[0], f[1]), pack2(f[2], f[3]));
  }
}

template <int E>
__device__ __forceinline__ void store(float* p, const float (&f)[E]) {
#pragma unroll
  for (int i = 0; i < E; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
}

// ------------------------------------------------- the forward's vector instance

constexpr int kVecWarps = 8;         // warps of a block, each on its own row
constexpr int kMaxDevices = 64;

// Columns of a lane's group: 8 where x, the residual and the output are all
// bf16 (one 16-byte vector each), else 4 (16 bytes of fp32, 8 of bf16), so
// that every load and store of a warp covers one contiguous run of a row.
template <typename TX, typename TR, typename TO, bool kRes>
__host__ __device__ constexpr int group_cols() {
  return sizeof(TX) == 2 && sizeof(TO) == 2 && (!kRes || sizeof(TR) == 2) ? 8 : 4;
}

// E values of T as loaded: 8, 16 or 32 bytes
template <typename T, int E>
struct Group {
  static constexpr int kWords = E * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[kWords];
};

template <typename T, int E>
__device__ __forceinline__ void load_group(Group<T, E>& g, const T* p) {
  if constexpr (Group<T, E>::kWords == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    g.w[0] = v.x;
    g.w[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < Group<T, E>::kWords / 4; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[q];
      g.w[4 * q] = v.x;
      g.w[4 * q + 1] = v.y;
      g.w[4 * q + 2] = v.z;
      g.w[4 * q + 3] = v.w;
    }
  }
}

template <int E>
__device__ __forceinline__ void to_f32(const Group<__nv_bfloat16, E>& g, float (&f)[E]) {
#pragma unroll
  for (int k = 0; k < E / 2; ++k) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&g.w[k]));
    f[2 * k] = v.x;
    f[2 * k + 1] = v.y;
  }
}

template <int E>
__device__ __forceinline__ void to_f32(const Group<float, E>& g, float (&f)[E]) {
#pragma unroll
  for (int k = 0; k < E; ++k) f[k] = __uint_as_float(g.w[k]);
}

template <typename T, int E>
__device__ __forceinline__ void load_f32(const T* p, float (&f)[E]) {
  Group<T, E> g;
  load_group(g, p);
  to_f32(g, f);
}

// rows of n = E * nv columns in groups of E = group_cols(), nv <= 32 * VPL
// groups (nv == 32 * VPL where kFull); the next row is prefetched into
// registers while this one is reduced and stored.
template <typename TX, typename TR, typename TO, bool kRes, int VPL, bool kFull>
__global__ void __launch_bounds__(kVecWarps * 32, 1)
ln_fwd_vec_kernel(const TX* __restrict__ x, const TR* __restrict__ res,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  TO* __restrict__ out, float* __restrict__ rstd_out, int rows, int n,
                  float eps) {
  constexpr int E = group_cols<TX, TR, TO, kRes>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = kFull ? 32 * VPL : n / E;
  const int step = gridDim.x * kVecWarps;       // warps of the grid
  int row = blockIdx.x * kVecWarps + warp;      // this warp's rows: row, row + step, ...
  if (row >= rows) return;                      // no block-wide barrier follows

  float sc[VPL][E], bs[VPL][E];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int vi = lane + 32 * i;
    if (kFull || vi < nv) {
      load_f32(scale + vi * E, sc[i]);
      load_f32(bias + vi * E, bs[i]);
    }
  }

  Group<TX, E> nx[VPL];                         // the next row
  Group<TR, E> nr[VPL];
  auto prefetch = [&](int r) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int vi = lane + 32 * i;
      if (kFull || vi < nv) {
        load_group(nx[i], x + static_cast<size_t>(r) * n + vi * E);
        if (kRes) load_group(nr[i], res + static_cast<size_t>(r) * n + vi * E);
      }
    }
  };
  prefetch(row);

  for (; row < rows; row += step) {
    float v[VPL][E];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int vi = lane + 32 * i;
      if (kFull || vi < nv) {
        to_f32(nx[i], v[i]);
        if (kRes) {
          float t[E];
          to_f32(nr[i], t);
#pragma unroll
          for (int e = 0; e < E; ++e) v[i][e] += t[e];
        }
      }
    }
    if (row + step < rows) prefetch(row + step);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (kFull || lane + 32 * i < nv) {
#pragma unroll
        for (int e = 0; e < E; ++e) sum += v[i][e];
      }
    }
    const float mean = k3m::warp_sum(sum) / n;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (kFull || lane + 32 * i < nv) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float d = v[i][e] - mean;
          v[i][e] = d;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(k3m::warp_sum(sq) / n + eps);
    TO* o = out + static_cast<size_t>(row) * n;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int vi = lane + 32 * i;
      if (kFull || vi < nv) {
        float y[E];
#pragma unroll
        for (int e = 0; e < E; ++e) y[e] = v[i][e] * rstd * sc[i][e] + bs[i][e];
        store<E>(o + vi * E, y);
      }
    }
    if (rstd_out != nullptr && lane == 0) rstd_out[row] = rstd;
  }
}

// Launches one instantiation on a persistent grid: the SMs times the blocks
// an SM holds (a wave), at most one warp per row. The occupancy query costs
// microseconds of host time, so its result is kept per device.
template <typename TX, typename TR, typename TO, bool kRes, int VPL, bool kFull>
int launch_vec(const void* x, const void* res, const float* scale, const float* bias, void* out,
               float* rstd, int rows, int n, float eps, cudaStream_t stream) {
  const auto kernel = ln_fwd_vec_kernel<TX, TR, TO, kRes, VPL, kFull>;
  static std::atomic<int> wave[kMaxDevices];     // blocks of a wave, 0 until queried
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = dev < kMaxDevices ? wave[dev].load(std::memory_order_relaxed) : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kVecWarps * 32, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    blocks = sms * per_sm;
    if (dev < kMaxDevices) wave[dev].store(blocks, std::memory_order_relaxed);
  }
  // one row per warp where the rows fit one wave of blocks; else one wave,
  // or two waves' worth where a wave's warps would take more than 4 rows
  // each, so that the hardware hands the last rows to whichever blocks are
  // free instead of leaving the wave's slowest warps a row behind
  const int want = (rows + kVecWarps - 1) / kVecWarps;
  const int grid = want <= blocks ? want : (want <= 4 * blocks ? blocks : 2 * blocks);
  kernel<<<grid, kVecWarps * 32, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TR*>(res), scale, bias, static_cast<TO*>(out),
      rstd, rows, n, eps);
  return static_cast<int>(cudaGetLastError());
}

// rows of kMaxN < n <= kMaxWideN columns in groups of E = group_cols()
// (nv = n / E <= 32 * VPL groups): a warp per row, the row in registers,
// scale and bias loaded per group as the row is stored.
template <typename TX, typename TR, typename TO, bool kRes, int VPL>
__global__ void __launch_bounds__(kVecWarps * 32)
ln_fwd_wide_kernel(const TX* __restrict__ x, const TR* __restrict__ res,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   TO* __restrict__ out, float* __restrict__ rstd_out, int rows, int n,
                   float eps) {
  constexpr int E = group_cols<TX, TR, TO, kRes>();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kVecWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nv = n / E;
  const size_t base = static_cast<size_t>(row) * n;
  float v[VPL][E];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nv) {
      load_f32(x + base + vi * E, v[i]);
      if (kRes) {
        float t[E];
        load_f32(res + base + vi * E, t);
#pragma unroll
        for (int e = 0; e < E; ++e) v[i][e] += t[e];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + 32 * i < nv) {
#pragma unroll
      for (int e = 0; e < E; ++e) sum += v[i][e];
    }
  }
  const float mean = k3m::warp_sum(sum) / n;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + 32 * i < nv) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = v[i][e] - mean;
        v[i][e] = d;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(k3m::warp_sum(sq) / n + eps);
  TO* o = out + base;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nv) {
      float sc[E], bs[E], y[E];
      load_f32(scale + vi * E, sc);
      load_f32(bias + vi * E, bs);
#pragma unroll
      for (int e = 0; e < E; ++e) y[e] = v[i][e] * rstd * sc[e] + bs[e];
      store<E>(o + vi * E, y);
    }
  }
  if (rstd_out != nullptr && lane == 0) rstd_out[row] = rstd;
}

template <typename TX, typename TR, typename TO, bool kRes>
int launch_wide(const void* x, const void* res, const float* scale, const float* bias,
                void* out, float* rstd, int rows, int n, float eps, cudaStream_t stream) {
  constexpr int E = group_cols<TX, TR, TO, kRes>();
  constexpr int VPL = kMaxWideN / (32 * E);   // 8 groups of 8 columns, or 16 of 4
  const int grid = (rows + kVecWarps - 1) / kVecWarps;
  ln_fwd_wide_kernel<TX, TR, TO, kRes, VPL><<<grid, kVecWarps * 32, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TR*>(res), scale, bias,
      static_cast<TO*>(out), rstd, rows, n, eps);
  return static_cast<int>(cudaGetLastError());
}

// One instantiation per groups-per-lane where the row fills them (256, 512,
// 768 and 1024 columns; 512 to 1024 where groups are of 4), one with
// predicates for every other width of whole groups up to kMaxN; wider rows
// take ln_fwd_wide_kernel.
template <typename TX, typename TR, typename TO, bool kRes>
int launch_vec_width(const void* x, const void* res, const float* scale, const float* bias,
                     void* out, float* rstd, int rows, int n, float eps, cudaStream_t stream) {
  constexpr int E = group_cols<TX, TR, TO, kRes>();
  const int nv = n / E;
  if (n > kMaxN)
    return launch_wide<TX, TR, TO, kRes>(x, res, scale, bias, out, rstd, rows, n, eps, stream);
#define K3M_LN_VEC(VPL, FULL) \
  launch_vec<TX, TR, TO, kRes, VPL, FULL>(x, res, scale, bias, out, rstd, rows, n, eps, stream)
  if constexpr (E == 8) {
    switch (nv) {
      case 32: return K3M_LN_VEC(1, true);
      case 64: return K3M_LN_VEC(2, true);
      case 96: return K3M_LN_VEC(3, true);
      case 128: return K3M_LN_VEC(4, true);
      default: return K3M_LN_VEC(4, false);
    }
  } else {
    switch (nv) {
      case 128: return K3M_LN_VEC(4, true);
      case 192: return K3M_LN_VEC(6, true);
      case 256: return K3M_LN_VEC(8, true);
      default: return K3M_LN_VEC(8, false);
    }
  }
#undef K3M_LN_VEC
}

template <typename TX, typename TO>
int launch_vec_res(const void* x, const void* res, int res_dtype, const void* scale,
                   const void* bias, void* out, float* rstd, int rows, int n, float eps,
                   cudaStream_t stream) {
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (res == nullptr)
    return launch_vec_width<TX, float, TO, false>(x, res, s, b, out, rstd, rows, n, eps, stream);
  if (res_dtype == k3m::kF32)
    return launch_vec_width<TX, float, TO, true>(x, res, s, b, out, rstd, rows, n, eps, stream);
  return launch_vec_width<TX, __nv_bfloat16, TO, true>(x, res, s, b, out, rstd, rows, n, eps,
                                                       stream);
}

// dx of the rows in this block's band, and the band's dscale/dbias partials.
// TY: dtype of y and dy (the forward's output dtype); TX: dtype of dx; VPL:
// 16-byte vectors of TY per lane and row (vectors past N are masked).
template <typename TY, typename TX, int VPL>
__global__ void __launch_bounds__(kBwdWarps * 32, 1)
ln_bwd_kernel(const TY* __restrict__ y, const float* __restrict__ rstd,
              const float* __restrict__ scale, const float* __restrict__ bias,
              const TY* __restrict__ dy, TX* __restrict__ dx,
              float* __restrict__ part_ds, float* __restrict__ part_db, int rows,
              int n, int band) {
  constexpr int E = VecOf<TY>::kElems;
  // the next row's loads overlap this row's arithmetic where the registers
  // allow it (bf16 up to 768 columns)
  constexpr bool kPrefetch = sizeof(TY) == 2 && VPL <= 3;
  __shared__ float red[kBwdWarps][kMaxN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = n / E;                         // vectors per row

  // this lane's columns: vector lane + 32 i, columns E (lane + 32 i) + e
  float sc[VPL][E], inv[VPL][E], bs[VPL][E], ads[VPL][E], adb[VPL][E];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int vi = lane + 32 * i;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = vi * E + e;
      const float s = vi < nv ? scale[c] : 1.f;
      sc[i][e] = s;
      inv[i][e] = 1.f / (fabsf(s) < 1e-6f ? 1e-6f : s);
      bs[i][e] = vi < nv ? bias[c] : 0.f;
      ads[i][e] = adb[i][e] = 0.f;
    }
  }

  const int r0 = blockIdx.x * band, r1 = min(r0 + band, rows);
  uint4 ny[VPL], ndy[VPL];
  float nr = 0.f;
  auto load_row = [&](int row, uint4 (&vy)[VPL], uint4 (&vdy)[VPL], float& r) {
    const size_t base = static_cast<size_t>(row) * nv;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int vi = lane + 32 * i;
      vy[i] = vdy[i] = make_uint4(0u, 0u, 0u, 0u);
      if (vi < nv) {
        vy[i] = reinterpret_cast<const uint4*>(y)[base + vi];
        vdy[i] = reinterpret_cast<const uint4*>(dy)[base + vi];
      }
    }
    r = rstd[row];
  };
  if (kPrefetch && r0 + warp < r1) load_row(r0 + warp, ny, ndy, nr);

  for (int row = r0 + warp; row < r1; row += kBwdWarps) {
    uint4 vy[VPL], vdy[VPL];
    float r;
    if constexpr (kPrefetch) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        vy[i] = ny[i];
        vdy[i] = ndy[i];
      }
      r = nr;
      if (row + kBwdWarps < r1) load_row(row + kBwdWarps, ny, ndy, nr);
    } else {
      load_row(row, vy, vdy, r);
    }
    // pass 1: the row sums of g = dy * scale and g * xhat; the band sums
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      float fy[E], fd[E];
      unpack(vy[i], fy);
      unpack(vdy[i], fd);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xh = (fy[e] - bs[i][e]) * inv[i][e];
        const float g = fd[e] * sc[i][e];
        sg += g;
        sgx += g * xh;
        ads[i][e] += fd[e] * xh;
        adb[i][e] += fd[e];
      }
    }
    const float gm = k3m::warp_sum(sg) / n, gxm = k3m::warp_sum(sgx) / n;
    // pass 2: dx = rstd (g - mean(g) - xhat mean(g xhat))
    TX* out = dx + static_cast<size_t>(row) * n;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int vi = lane + 32 * i;
      if (vi >= nv) continue;
      float fy[E], fd[E], o[E];
      unpack(vy[i], fy);
      unpack(vdy[i], fd);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xh = (fy[e] - bs[i][e]) * inv[i][e];
        o[e] = r * (fd[e] * sc[i][e] - gm - xh * gxm);
      }
      store<E>(out + vi * E, o);
    }
  }

  // the block's partials: its warps added in a fixed order
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float* part = pass == 0 ? part_ds : part_db;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nv) {
#pragma unroll
        for (int e = 0; e < E; ++e) red[warp][vi * E + e] = pass == 0 ? ads[i][e] : adb[i][e];
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < n; c += kBwdWarps * 32) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) sum += red[w][c];
      part[static_cast<size_t>(blockIdx.x) * n + c] = sum;
    }
    __syncthreads();
  }
}

// ln_bwd_kernel for rows of kMaxN < n <= kMaxWideN columns (VPL: 16-byte
// vectors of TY per lane and row at kMaxWideN): scale, 1 / safe(scale),
// bias and each warp's dscale/dbias sums in dynamic shared memory, column
// vi * E + e at word e * nv + vi (the header), (3 + 2 kBwdWarps) n floats.
template <typename TY, typename TX, int VPL>
__global__ void __launch_bounds__(kBwdWarps * 32, 1)
ln_bwd_wide_kernel(const TY* __restrict__ y, const float* __restrict__ rstd,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const TY* __restrict__ dy, TX* __restrict__ dx,
                   float* __restrict__ part_ds, float* __restrict__ part_db, int rows,
                   int n, int band) {
  constexpr int E = VecOf<TY>::kElems;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = n / E;                         // vectors per row
  float* s_sc = smem;
  float* s_inv = smem + n;
  float* s_bs = smem + 2 * n;
  float* acc = smem + 3 * n;                    // [kBwdWarps][dscale, dbias][n]
  for (int k = threadIdx.x; k < n; k += kBwdWarps * 32) {   // word k: column c
    const int c = (k % nv) * E + k / nv;
    const float s = scale[c];
    s_sc[k] = s;
    s_inv[k] = 1.f / (fabsf(s) < 1e-6f ? 1e-6f : s);
    s_bs[k] = bias[c];
  }
  for (int c = threadIdx.x; c < 2 * kBwdWarps * n; c += kBwdWarps * 32) acc[c] = 0.f;
  __syncthreads();
  float* ads = acc + 2 * warp * n;
  float* adb = ads + n;

  const int r0 = blockIdx.x * band, r1 = min(r0 + band, rows);
  for (int row = r0 + warp; row < r1; row += kBwdWarps) {
    const size_t base = static_cast<size_t>(row) * nv;
    uint4 vy[VPL], vdy[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nv) {
        vy[i] = reinterpret_cast<const uint4*>(y)[base + vi];
        vdy[i] = reinterpret_cast<const uint4*>(dy)[base + vi];
      }
    }
    const float r = rstd[row];
    // pass 1: xhat and g = dy * scale kept, their row sums, the warp's sums
    float xh[VPL][E], g[VPL][E];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nv) {
        float fy[E], fd[E];
        unpack(vy[i], fy);
        unpack(vdy[i], fd);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int k = e * nv + vi;
          const float x = (fy[e] - s_bs[k]) * s_inv[k];
          const float gg = fd[e] * s_sc[k];
          xh[i][e] = x;
          g[i][e] = gg;
          sg += gg;
          sgx += gg * x;
          ads[k] += fd[e] * x;
          adb[k] += fd[e];
        }
      }
    }
    const float gm = k3m::warp_sum(sg) / n, gxm = k3m::warp_sum(sgx) / n;
    // pass 2: dx = rstd (g - mean(g) - xhat mean(g xhat))
    TX* out = dx + static_cast<size_t>(row) * n;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nv) {
        float o[E];
#pragma unroll
        for (int e = 0; e < E; ++e) o[e] = r * (g[i][e] - gm - xh[i][e] * gxm);
        store<E>(out + vi * E, o);
      }
    }
  }
  __syncthreads();
  // the block's partials: its warps added in a fixed order
  for (int k = threadIdx.x; k < n; k += kBwdWarps * 32) {
    const int c = (k % nv) * E + k / nv;
    float ds = 0.f, db = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) {
      ds += acc[2 * w * n + k];
      db += acc[(2 * w + 1) * n + k];
    }
    part_ds[static_cast<size_t>(blockIdx.x) * n + c] = ds;
    part_db[static_cast<size_t>(blockIdx.x) * n + c] = db;
  }
}

// dscale[c] (blockIdx.y 0) or dbias[c] (1) = the sum over bands p of the
// partials [p][c], in band order: warp w adds bands w, w + 8, ..., then
// warp 0 adds the 8 warps in order. One lane per column of a 32-column group.
__global__ void __launch_bounds__(kBwdWarps * 32)
ln_bwd_reduce_kernel(const float* __restrict__ part_ds, const float* __restrict__ part_db,
                     int bands, int n, float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float red[kBwdWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const float* part = blockIdx.y == 0 ? part_ds : part_db;
  float sum = 0.f;
  if (c < n) {
#pragma unroll 8
    for (int p = warp; p < bands; p += kBwdWarps) sum += part[static_cast<size_t>(p) * n + c];
  }
  red[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && c < n) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) total += red[w][lane];
    (blockIdx.y == 0 ? dscale : dbias)[c] = total;
  }
}

// Bands (blocks) of the backward for `rows` rows: two waves of the card's
// SMs at one block per SM, and at least a warp's row per band. The SM count
// is read from the current device at every call (a cheap query).
int bands_for(int rows) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms <= 0)
    sms = 132;
  const int want = (rows + kBwdWarps - 1) / kBwdWarps;
  return want < 2 * sms ? want : 2 * sms;
}

template <typename TY, typename TX, int VPL>
void launch_bwd_vpl(const void* y, const float* rstd, const float* scale, const float* bias,
                    const void* dy, void* dx, float* part_ds, float* part_db, int rows, int n,
                    int bands, int band, cudaStream_t stream) {
  ln_bwd_kernel<TY, TX, VPL><<<bands, kBwdWarps * 32, 0, stream>>>(
      static_cast<const TY*>(y), rstd, scale, bias, static_cast<const TY*>(dy),
      static_cast<TX*>(dx), part_ds, part_db, rows, n, band);
}

template <typename TY, typename TX>
int launch_bwd(const void* y, const float* rstd, const float* scale, const float* bias,
               const void* dy, void* dx, float* part, float* dscale, float* dbias,
               int rows, int n, cudaStream_t stream) {
  constexpr int E = VecOf<TY>::kElems;
  if (n % E || reinterpret_cast<uintptr_t>(y) % 16 || reinterpret_cast<uintptr_t>(dy) % 16 ||
      reinterpret_cast<uintptr_t>(dx) % 16)
    return cudaErrorInvalidValue;
  const int bands = bands_for(rows);
  const int band = (rows + bands - 1) / bands;
  float* part_ds = part;
  float* part_db = part + static_cast<size_t>(bands) * n;
  const int vpl = (n / E + 31) / 32;
  if (n > kMaxN) {
    constexpr int V = kMaxWideN / (32 * E);
    const auto kernel = ln_bwd_wide_kernel<TY, TX, V>;
    const int smem = (3 + 2 * kBwdWarps) * n * static_cast<int>(sizeof(float));
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<bands, kBwdWarps * 32, smem, stream>>>(
        static_cast<const TY*>(y), rstd, scale, bias, static_cast<const TY*>(dy),
        static_cast<TX*>(dx), part_ds, part_db, rows, n, band);
  } else {
    switch (vpl) {
#define K3M_LN_BWD_CASE(V)                                                              \
    case V:                                                                             \
      launch_bwd_vpl<TY, TX, V>(y, rstd, scale, bias, dy, dx, part_ds, part_db, rows, n, \
                                bands, band, stream);                                    \
      break;
      K3M_LN_BWD_CASE(1)
      K3M_LN_BWD_CASE(2)
      K3M_LN_BWD_CASE(3)
      K3M_LN_BWD_CASE(4)
#undef K3M_LN_BWD_CASE
      default:
        if constexpr (E == 4) {   // fp32 y: up to 8 vectors per lane
          if (vpl <= 6)
            launch_bwd_vpl<TY, TX, 6>(y, rstd, scale, bias, dy, dx, part_ds, part_db, rows, n,
                                      bands, band, stream);
          else
            launch_bwd_vpl<TY, TX, 8>(y, rstd, scale, bias, dy, dx, part_ds, part_db, rows, n,
                                      bands, band, stream);
          break;
        }
        return cudaErrorInvalidValue;
    }
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ln_bwd_reduce_kernel<<<dim3((n + 31) / 32, 2), kBwdWarps * 32, 0, stream>>>(
      part_ds, part_db, bands, n, dscale, dbias);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `vec`: 1 for the vector instance (n a multiple of 8 up to kMaxWideN; x,
// res, out, scale and bias 16-byte aligned; cudaErrorInvalidValue
// otherwise), 0 for the per-element one (any width up to kMaxN, any
// alignment). Returns
// cudaGetLastError() after the launch (0 on success). `rstd` may be null
// (no gradient needed); otherwise it receives fp32 [rows].
extern "C" int k3m_layernorm_fwd(const void* x, int x_dtype, const void* res,
                                 int res_dtype, const void* scale, const void* bias,
                                 void* out, int out_dtype, float* rstd, int rows, int n,
                                 float eps, int vec, void* stream_ptr) {
  if (n <= 0 || n > (vec ? kMaxWideN : kMaxN) || rows <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (vec) {
    if (n % 8 || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(res) % 16 ||
        reinterpret_cast<uintptr_t>(out) % 16 || reinterpret_cast<uintptr_t>(scale) % 16 ||
        reinterpret_cast<uintptr_t>(bias) % 16)
      return cudaErrorInvalidValue;
    if (x_dtype == k3m::kF32 && out_dtype == k3m::kF32)
      return launch_vec_res<float, float>(x, res, res_dtype, scale, bias, out, rstd, rows, n, eps,
                                          stream);
    if (x_dtype == k3m::kF32)
      return launch_vec_res<float, __nv_bfloat16>(x, res, res_dtype, scale, bias, out, rstd, rows,
                                                  n, eps, stream);
    if (out_dtype == k3m::kF32)
      return launch_vec_res<__nv_bfloat16, float>(x, res, res_dtype, scale, bias, out, rstd, rows,
                                                  n, eps, stream);
    return launch_vec_res<__nv_bfloat16, __nv_bfloat16>(x, res, res_dtype, scale, bias, out, rstd,
                                                         rows, n, eps, stream);
  }
  if (x_dtype == k3m::kF32 && out_dtype == k3m::kF32)
    launch_elem_res<float, float>(x, res, res_dtype, scale, bias, out, rstd, rows, n, eps, stream);
  else if (x_dtype == k3m::kF32 && out_dtype == k3m::kBF16)
    launch_elem_res<float, __nv_bfloat16>(x, res, res_dtype, scale, bias, out, rstd, rows, n, eps,
                                          stream);
  else if (x_dtype == k3m::kBF16 && out_dtype == k3m::kF32)
    launch_elem_res<__nv_bfloat16, float>(x, res, res_dtype, scale, bias, out, rstd, rows, n, eps,
                                          stream);
  else
    launch_elem_res<__nv_bfloat16, __nv_bfloat16>(x, res, res_dtype, scale, bias, out, rstd, rows,
                                                  n, eps, stream);
  return static_cast<int>(cudaGetLastError());
}

// Number of row bands (blocks) of the backward for `rows` rows: the caller
// allocates 2 * bands * n fp32 partials.
extern "C" int k3m_ln_bwd_bands(int rows) { return bands_for(rows); }

// y, dy: [rows, n] in y_dtype (the forward's output dtype), contiguous and
// 16-byte aligned, n a multiple of 8 (bf16) or 4 (fp32) up to kMaxWideN;
// rstd fp32 [rows];
// dx: [rows, n] in x_dtype; dscale, dbias fp32 [n]; part: fp32 scratch of
// 2 * k3m_ln_bwd_bands(rows) * n. Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int k3m_layernorm_bwd(const void* y, int y_dtype, const float* rstd,
                                 const float* scale, const float* bias, const void* dy,
                                 void* dx, int x_dtype, float* part, float* dscale,
                                 float* dbias, int rows, int n, void* stream_ptr) {
  if (n <= 0 || n > kMaxWideN || rows <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (y_dtype == k3m::kF32 && x_dtype == k3m::kF32)
    return launch_bwd<float, float>(y, rstd, scale, bias, dy, dx, part, dscale, dbias, rows, n, stream);
  if (y_dtype == k3m::kF32)
    return launch_bwd<float, __nv_bfloat16>(y, rstd, scale, bias, dy, dx, part, dscale, dbias, rows, n, stream);
  if (x_dtype == k3m::kF32)
    return launch_bwd<__nv_bfloat16, float>(y, rstd, scale, bias, dy, dx, part, dscale, dbias, rows, n, stream);
  return launch_bwd<__nv_bfloat16, __nv_bfloat16>(y, rstd, scale, bias, dy, dx, part, dscale, dbias, rows, n, stream);
}
