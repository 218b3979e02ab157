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
// flops per element, far below the card's flop/byte balance. Design: one
// warp per row (N <= 1024), so a row lives in 32 registers per lane; the
// row statistics come from warp shuffles, and nothing but the row tensors
// touches device memory. Lane l handles columns l, l+32, ..., so each warp
// load is one contiguous run of the row.
//
// The TPU sums dscale/dbias across its sequential grid in VMEM. Blocks on
// the card run in no order, so each block takes a band of rows, each of its
// warps sums its rows' dy * xhat and dy into its own shared-memory row, the
// block adds its warps in a fixed order and writes fp32 partials
// [n_blocks, N]; a second small kernel adds the partials in a fixed order.
// No atomics: the parameter gradients are the same in every run.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // rows in flight per CTA
constexpr int kMaxPerLane = 32;    // N <= 32 * 32
constexpr int kMaxN = 32 * kMaxPerLane;
constexpr int kMaxBands = 512;     // blocks of the backward (partials rows)

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

// dx of the rows in this block's band, and the band's dscale/dbias partials.
// TY: dtype of y and dy (the forward's output dtype); TX: dtype of dx.
template <typename TY, typename TX>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_kernel(const TY* __restrict__ y, const float* __restrict__ rstd,
              const float* __restrict__ scale, const float* __restrict__ bias,
              const TY* __restrict__ dy, TX* __restrict__ dx,
              float* __restrict__ part_ds, float* __restrict__ part_db, int rows,
              int n, int band) {
  __shared__ float sds[kWarps][kMaxN];
  __shared__ float sdb[kWarps][kMaxN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a lane owns columns lane + 32 i of its warp's rows: no two threads
  // touch one shared word until the fixed-order sum at the end
  for (int c = lane; c < n; c += 32) sds[warp][c] = sdb[warp][c] = 0.f;
  const int r0 = blockIdx.x * band, r1 = min(r0 + band, rows);
  for (int row = r0 + warp; row < r1; row += kWarps) {
    const size_t base = static_cast<size_t>(row) * n;
    float xh[kMaxPerLane], g[kMaxPerLane];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      xh[i] = g[i] = 0.f;
      if (c < n) {
        const float s = scale[c];
        const float safe = fabsf(s) < 1e-6f ? 1e-6f : s;
        const float x = (k3m::to_f32(y[base + c]) - bias[c]) / safe;
        const float d = k3m::to_f32(dy[base + c]);
        xh[i] = x;
        g[i] = d * s;
        sg += g[i];
        sgx += g[i] * x;
        sds[warp][c] += d * x;
        sdb[warp][c] += d;
      }
    }
    const float gm = k3m::warp_sum(sg) / n, gxm = k3m::warp_sum(sgx) / n;
    const float r = rstd[row];
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < n) dx[base + c] = k3m::from_f32<TX>(r * (g[i] - gm - xh[i] * gxm));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += kWarps * 32) {
    float ds = 0.f, db = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ds += sds[w][c];
      db += sdb[w][c];
    }
    part_ds[static_cast<size_t>(blockIdx.x) * n + c] = ds;
    part_db[static_cast<size_t>(blockIdx.x) * n + c] = db;
  }
}

// dscale[c] = sum over bands p of part_ds[p][c], in band order; dbias alike.
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ part_ds,
                                     const float* __restrict__ part_db, int bands,
                                     int n, float* __restrict__ dscale,
                                     float* __restrict__ dbias) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  float ds = 0.f, db = 0.f;
  for (int p = 0; p < bands; ++p) {
    ds += part_ds[static_cast<size_t>(p) * n + c];
    db += part_db[static_cast<size_t>(p) * n + c];
  }
  dscale[c] = ds;
  dbias[c] = db;
}

int bands_for(int rows) {
  const int want = (rows + kWarps - 1) / kWarps;
  return want < kMaxBands ? want : kMaxBands;
}

template <typename TY, typename TX>
int launch_bwd(const void* y, const float* rstd, const float* scale, const float* bias,
               const void* dy, void* dx, float* part, float* dscale, float* dbias,
               int rows, int n, cudaStream_t stream) {
  const int bands = bands_for(rows);
  const int band = (rows + bands - 1) / bands;
  float* part_ds = part;
  float* part_db = part + static_cast<size_t>(bands) * n;
  ln_bwd_kernel<TY, TX><<<bands, kWarps * 32, 0, stream>>>(
      static_cast<const TY*>(y), rstd, scale, bias, static_cast<const TY*>(dy),
      static_cast<TX*>(dx), part_ds, part_db, rows, n, band);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ln_bwd_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part_ds, part_db, bands, n,
                                                             dscale, dbias);
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

// y, dy: [rows, n] in y_dtype (the forward's output dtype); rstd fp32
// [rows]; dx: [rows, n] in x_dtype; dscale, dbias fp32 [n]; part: fp32
// scratch of 2 * k3m_ln_bwd_bands(rows) * n. Returns cudaGetLastError()
// after the launches (0 on success).
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
