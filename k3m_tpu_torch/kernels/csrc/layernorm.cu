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
// Forward design: one warp per row (N <= 1024), so a row lives in 32
// registers per lane; the row statistics come from warp shuffles, and
// nothing but the row tensors touches device memory. Lane l handles columns
// l, l+32, ..., so each warp load is one contiguous run of the row.
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
// multiple of 8 in bf16, of 4 in fp32).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // rows in flight per CTA
constexpr int kMaxPerLane = 32;    // N <= 32 * 32
constexpr int kMaxN = 32 * kMaxPerLane;

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
void launch(const void* x, const void* res, const void* scale, const void* bias,
            void* out, float* rstd, int rows, int n, float eps, cudaStream_t stream) {
  const int grid = (rows + kWarps - 1) / kWarps;
  ln_fwd_kernel<TX, TR, TO, kRes><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TR*>(res),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<TO*>(out), rstd, rows, n, eps);
}

template <typename TX, typename TO>
void launch_res(const void* x, const void* res, int res_dtype, const void* scale,
                const void* bias, void* out, float* rstd, int rows, int n, float eps,
                cudaStream_t stream) {
  if (res == nullptr)
    launch<TX, float, TO, false>(x, res, scale, bias, out, rstd, rows, n, eps, stream);
  else if (res_dtype == k3m::kF32)
    launch<TX, float, TO, true>(x, res, scale, bias, out, rstd, rows, n, eps, stream);
  else
    launch<TX, __nv_bfloat16, TO, true>(x, res, scale, bias, out, rstd, rows, n, eps, stream);
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
  switch (vpl) {
#define K3M_LN_BWD_CASE(V)                                                                  \
  case V:                                                                                   \
    launch_bwd_vpl<TY, TX, V>(y, rstd, scale, bias, dy, dx, part_ds, part_db, rows, n,     \
                              bands, band, stream);                                        \
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
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ln_bwd_reduce_kernel<<<dim3((n + 31) / 32, 2), kBwdWarps * 32, 0, stream>>>(
      part_ds, part_db, bands, n, dscale, dbias);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). `rstd` may be
// null (no gradient needed); otherwise it receives fp32 [rows].
extern "C" int k3m_layernorm_fwd(const void* x, int x_dtype, const void* res,
                                 int res_dtype, const void* scale, const void* bias,
                                 void* out, int out_dtype, float* rstd, int rows, int n,
                                 float eps, void* stream_ptr) {
  if (n <= 0 || n > kMaxN || rows <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (x_dtype == k3m::kF32 && out_dtype == k3m::kF32)
    launch_res<float, float>(x, res, res_dtype, scale, bias, out, rstd, rows, n, eps, stream);
  else if (x_dtype == k3m::kF32 && out_dtype == k3m::kBF16)
    launch_res<float, __nv_bfloat16>(x, res, res_dtype, scale, bias, out, rstd, rows, n, eps, stream);
  else if (x_dtype == k3m::kBF16 && out_dtype == k3m::kF32)
    launch_res<__nv_bfloat16, float>(x, res, res_dtype, scale, bias, out, rstd, rows, n, eps, stream);
  else
    launch_res<__nv_bfloat16, __nv_bfloat16>(x, res, res_dtype, scale, bias, out, rstd, rows, n, eps, stream);
  return static_cast<int>(cudaGetLastError());
}

// Number of row bands (blocks) of the backward for `rows` rows: the caller
// allocates 2 * bands * n fp32 partials.
extern "C" int k3m_ln_bwd_bands(int rows) { return bands_for(rows); }

// y, dy: [rows, n] in y_dtype (the forward's output dtype), contiguous and
// 16-byte aligned, n a multiple of 8 (bf16) or 4 (fp32); rstd fp32 [rows];
// dx: [rows, n] in x_dtype; dscale, dbias fp32 [n]; part: fp32 scratch of
// 2 * k3m_ln_bwd_bands(rows) * n. Returns cudaGetLastError() after the
// launches (0 on success).
extern "C" int k3m_layernorm_bwd(const void* y, int y_dtype, const float* rstd,
                                 const float* scale, const float* bias, const void* dy,
                                 void* dx, int x_dtype, float* part, float* dscale,
                                 float* dbias, int rows, int n, void* stream_ptr) {
  if (n <= 0 || n > kMaxN || rows <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (y_dtype == k3m::kF32 && x_dtype == k3m::kF32)
    return launch_bwd<float, float>(y, rstd, scale, bias, dy, dx, part, dscale, dbias, rows, n, stream);
  if (y_dtype == k3m::kF32)
    return launch_bwd<float, __nv_bfloat16>(y, rstd, scale, bias, dy, dx, part, dscale, dbias, rows, n, stream);
  if (x_dtype == k3m::kF32)
    return launch_bwd<__nv_bfloat16, float>(y, rstd, scale, bias, dy, dx, part, dscale, dbias, rows, n, stream);
  return launch_bwd<__nv_bfloat16, __nv_bfloat16>(y, rstd, scale, bias, dy, dx, part, dscale, dbias, rows, n, stream);
}
