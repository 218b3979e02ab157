// Fused (residual add +) LayerNorm forward.
//
// Replaces: k3m_tpu/kernels/layernorm.py:_ln_fwd_kernel (called from
// _fwd_call). Computes y = LN(x [+ res]) * scale + bias over the last axis,
// TF style (eps inside the rsqrt), with a two-pass fp32 mean and centered
// variance, and casts to the output dtype in the kernel.
//
// Bound on the H100: device-memory bytes. Each element is read once (x, and
// res when given) and written once, with ~10 flops per element, far below
// the card's flop/byte balance. Design: one warp per row (N <= 1024), so a
// row lives in 32 registers per lane; both statistics come from warp
// shuffles over those registers, and nothing but x, res and y touches device
// memory. Lane l handles columns l, l+32, ..., so each warp load is one
// contiguous run of the row.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // rows per CTA
constexpr int kMaxPerLane = 32;    // N <= 32 * 32

template <typename TX, typename TR, typename TO, bool kRes>
__global__ void __launch_bounds__(kWarps * 32)
ln_fwd_kernel(const TX* __restrict__ x, const TR* __restrict__ res,
              const float* __restrict__ scale, const float* __restrict__ bias,
              TO* __restrict__ out, int rows, int n, float eps) {
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
}

template <typename TX, typename TR, typename TO, bool kRes>
void launch(const void* x, const void* res, const void* scale, const void* bias,
            void* out, int rows, int n, float eps, cudaStream_t stream) {
  const int grid = (rows + kWarps - 1) / kWarps;
  ln_fwd_kernel<TX, TR, TO, kRes><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TR*>(res),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<TO*>(out), rows, n, eps);
}

template <typename TX, typename TO>
void launch_res(const void* x, const void* res, int res_dtype, const void* scale,
                const void* bias, void* out, int rows, int n, float eps,
                cudaStream_t stream) {
  if (res == nullptr)
    launch<TX, float, TO, false>(x, res, scale, bias, out, rows, n, eps, stream);
  else if (res_dtype == k3m::kF32)
    launch<TX, float, TO, true>(x, res, scale, bias, out, rows, n, eps, stream);
  else
    launch<TX, __nv_bfloat16, TO, true>(x, res, scale, bias, out, rows, n, eps, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int k3m_layernorm_fwd(const void* x, int x_dtype, const void* res,
                                 int res_dtype, const void* scale, const void* bias,
                                 void* out, int out_dtype, int rows, int n,
                                 float eps, void* stream_ptr) {
  if (n <= 0 || n > 32 * kMaxPerLane || rows <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (x_dtype == k3m::kF32 && out_dtype == k3m::kF32)
    launch_res<float, float>(x, res, res_dtype, scale, bias, out, rows, n, eps, stream);
  else if (x_dtype == k3m::kF32 && out_dtype == k3m::kBF16)
    launch_res<float, __nv_bfloat16>(x, res, res_dtype, scale, bias, out, rows, n, eps, stream);
  else if (x_dtype == k3m::kBF16 && out_dtype == k3m::kF32)
    launch_res<__nv_bfloat16, float>(x, res, res_dtype, scale, bias, out, rows, n, eps, stream);
  else
    launch_res<__nv_bfloat16, __nv_bfloat16>(x, res, res_dtype, scale, bias, out, rows, n, eps, stream);
  return static_cast<int>(cudaGetLastError());
}
