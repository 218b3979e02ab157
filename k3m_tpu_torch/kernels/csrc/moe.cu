// The held experts' per-pair work of the DeepSeek-V2 MoE
// (k3m_tpu_torch/model/deepseek.py `_HeldExperts`, wrapped by
// k3m_tpu_torch/kernels/moe.py): the gather of the sorted (row, choice)
// pairs' input rows, SwiGLU forward and backward on the gate/up grouped
// GEMM's output, the weighted sum of each token row's pairs (the combine)
// and its backward, and the sum of each token row's pairs' input gradients.
//
// Replaces: no TPU kernel. The JAX package has no mixture of experts. The
// port's DeepSeek-V2 block sorts every (row, choice) pair of a layer, R =
// N k rows, while one card's share of the experts holds about 1/8 of them;
// the per-pair work ran as a dozen PyTorch operations over all R rows
// (gathers, masks, SwiGLU on strided halves, an fp32 chain for its
// gradient, [N, k, hidden] products for the combine). These kernels do that
// work over the held pairs alone, each in one pass.
//
// Bound on the H100: device-memory bytes. Each moves a row of 2.8-5.6 KB in
// bf16 a pair with a few flops an element, far below the card's flop/byte
// balance; the least time is the bytes of the held rows read once and
// written once at 3.35 TB/s. The design:
// - The held-pair count n = offs[groups - 1] (the end of the last held
//   expert's group) is read on the device. A sorted row p >= n is neither
//   read nor written (the grouped GEMMs neither read nor write it either),
//   and a block whose first row lies at or past n returns at once: the work
//   follows the held pairs and no count reaches the host.
// - The gather writes a sorted row p < n whose valid[p] is false as zeros.
//   The other kernels need no mask: the experts' Linears have no bias, so
//   such a row's h, a and y are zeros, its weighted sum adds 0, and its
//   gradients dh, dx and the weight's are zeros, all exactly.
// - One warp per row at a time, grid-stride over a grid of at most
//   kBlocksPerSm blocks of kWarps warps an SM, sized for the capacity R so
//   that every held row has a warp at the cell's sizes; 16-byte loads and
//   stores, neighbouring lanes on neighbouring vectors; fp32 arithmetic,
//   bf16 in and out (the gather copies bytes and takes any dtype). Where the
//   former operations kept a bf16 tensor (silu(g), the weights cast to bf16,
//   each weighted pair) the value is rounded to bf16 there too, so that the
//   forward gives the former bits: a rounding of its own would move the
//   routing of the later layers' near ties, and with it which rows an
//   expert's gradient holds.
// - The combine, its backward and the gradient's sum take one warp per token
//   row m: lane j < k reads pair j's sorted row from `inv` and whether it is
//   held, and every lane gets them by shuffles. The sum over a row's pairs
//   is formed in registers in a fixed order (j = 0 .. k - 1), so no [N, k,
//   hidden] tensor is written and each run gives the same bits. The
//   backward reads dout[m] once, writes each held pair's dy row (w dout)
//   and sums the weight's gradient dout . y per pair in fp32 across the
//   warp.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;         // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 8;   // 64 warps: a full SM
constexpr int kMaxK = 8;          // the most pairs a token row has
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return raw;
}

// The rounding and the formulas of the PyTorch operations the kernels
// replace: a tensor that was bf16 there is rounded to bf16 here, and silu
// and sigmoid are x / (1 + exp(-x)) and 1 / (1 + exp(-x)) with the accurate
// expf, so that the forward gives the former bits.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// n, the held pairs: the end of the last group, at most the capacity
__device__ __forceinline__ int held_count(const int* offs, int groups, int rows) {
  const int n = __ldg(offs + groups - 1);
  return n < rows ? n : rows;
}

__device__ __forceinline__ int first_warp() { return blockIdx.x * kWarps + threadIdx.x / 32; }
__device__ __forceinline__ int warp_stride() { return gridDim.x * kWarps; }

__device__ __forceinline__ void zero_row(uint4* row, int vecs, int lane) {
  for (int v = lane; v < vecs; v += 32) row[v] = make_uint4(0u, 0u, 0u, 0u);
}

// x[p] = u[tok[p]] for p < n; rows of `vecs` 16-byte vectors.
__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint4* __restrict__ u, const int64_t* __restrict__ tok,
              const int* __restrict__ offs, int groups, const bool* __restrict__ valid,
              uint4* __restrict__ x, int rows, int vecs) {
  const int n = held_count(offs, groups, rows);
  const int lane = threadIdx.x & 31;
  for (int p = first_warp(); p < n; p += warp_stride()) {
    uint4* dst = x + static_cast<size_t>(p) * vecs;
    if (!valid[p]) {
      zero_row(dst, vecs, lane);
      continue;
    }
    const uint4* src = u + static_cast<size_t>(tok[p]) * vecs;
#pragma unroll 4
    for (int v = lane; v < vecs; v += 32) dst[v] = __ldg(src + v);
  }
}

// a[p] = silu(g) up for p < n (silu(g) rounded to bf16 first), h[p] = [g |
// up], each `vecs` vectors of 8.
__global__ void __launch_bounds__(kThreads)
swiglu_fwd_kernel(const uint4* __restrict__ h, const int* __restrict__ offs, int groups,
                  uint4* __restrict__ a, int rows, int vecs) {
  const int n = held_count(offs, groups, rows);
  const int lane = threadIdx.x & 31;
  for (int p = first_warp(); p < n; p += warp_stride()) {
    uint4* out = a + static_cast<size_t>(p) * vecs;
    const uint4* g = h + static_cast<size_t>(p) * 2 * vecs;
    const uint4* up = g + vecs;
#pragma unroll 2
    for (int v = lane; v < vecs; v += 32) {
      float gf[8], uf[8], r[8];
      unpack(__ldg(g + v), gf);
      unpack(__ldg(up + v), uf);
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = round_bf16(silu(gf[i])) * uf[i];
      out[v] = pack(r);
    }
  }
}

// dh[p] = [da up s (1 + g (1 - s)) | da silu(g)], s = sigmoid(g), for p <
// n (silu(g) rounded to bf16 first).
__global__ void __launch_bounds__(kThreads)
swiglu_bwd_kernel(const uint4* __restrict__ h, const uint4* __restrict__ da,
                  const int* __restrict__ offs, int groups, uint4* __restrict__ dh, int rows,
                  int vecs) {
  const int n = held_count(offs, groups, rows);
  const int lane = threadIdx.x & 31;
  for (int p = first_warp(); p < n; p += warp_stride()) {
    uint4* dg = dh + static_cast<size_t>(p) * 2 * vecs;
    uint4* dup = dg + vecs;
    const uint4* g = h + static_cast<size_t>(p) * 2 * vecs;
    const uint4* up = g + vecs;
    const uint4* d = da + static_cast<size_t>(p) * vecs;
#pragma unroll 2
    for (int v = lane; v < vecs; v += 32) {
      float gf[8], uf[8], df[8], rg[8], ru[8];
      unpack(__ldg(g + v), gf);
      unpack(__ldg(up + v), uf);
      unpack(__ldg(d + v), df);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float s = sigmoid(gf[i]);
        rg[i] = df[i] * uf[i] * s * (1.f + gf[i] * (1.f - s));
        ru[i] = df[i] * round_bf16(silu(gf[i]));
      }
      dg[v] = pack(rg);
      dup[v] = pack(ru);
    }
  }
}

// out[m] = sum over the held pairs j of row m (p = inv[m k + j] < n) of
// w[m k + j] y[p], the weight and each product rounded to bf16
// first; w = 1 where `kWeighted` is false (the sum of the pairs' input
// gradients).
template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const uint4* __restrict__ y, const int64_t* __restrict__ inv,
               const float* __restrict__ w, const int* __restrict__ offs, int groups,
               uint4* __restrict__ out, int pairs, int rows, int k, int vecs) {
  const int n = held_count(offs, groups, pairs);
  const int lane = threadIdx.x & 31;
  for (int m = first_warp(); m < rows; m += warp_stride()) {
    int mine = -1;  // lane j < k: pair j's sorted row where it is held
    float wm = 0.f;
    if (lane < k) {
      const int64_t p = inv[static_cast<size_t>(m) * k + lane];
      if (p < n) {
        mine = static_cast<int>(p);
        wm = kWeighted ? round_bf16(w[static_cast<size_t>(m) * k + lane]) : 1.f;
      }
    }
    int pj[kMaxK];
    float wj[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      pj[j] = __shfl_sync(kFull, mine, j);
      wj[j] = __shfl_sync(kFull, wm, j);
    }
    uint4* dst = out + static_cast<size_t>(m) * vecs;
    for (int v = lane; v < vecs; v += 32) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (pj[j] < 0) continue;
        float f[8];
        unpack(__ldg(y + static_cast<size_t>(pj[j]) * vecs + v), f);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += kWeighted ? round_bf16(wj[j] * f[i]) : f[i];
      }
      dst[v] = pack(acc);
    }
  }
}

// For each held pair j of row m (p = inv[m k + j] < n): dy[p] = w[m k + j]
// dout[m] (the weight rounded to bf16 first) and dw[m k + j] = dout[m] .
// y[p] in fp32; dw is 0 for the pairs not held.
__global__ void __launch_bounds__(kThreads)
combine_bwd_kernel(const uint4* __restrict__ dout, const uint4* __restrict__ y,
                   const int64_t* __restrict__ inv, const float* __restrict__ w,
                   const int* __restrict__ offs, int groups, uint4* __restrict__ dy,
                   float* __restrict__ dw, int pairs, int rows, int k, int vecs) {
  const int n = held_count(offs, groups, pairs);
  const int lane = threadIdx.x & 31;
  for (int m = first_warp(); m < rows; m += warp_stride()) {
    int mine = -1;  // lane j < k: pair j's sorted row where it is held
    float wm = 0.f;
    if (lane < k) {
      const int64_t p = inv[static_cast<size_t>(m) * k + lane];
      if (p < n) {
        mine = static_cast<int>(p);
        wm = round_bf16(w[static_cast<size_t>(m) * k + lane]);
      }
    }
    int pj[kMaxK];
    float wj[kMaxK], dot[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      pj[j] = __shfl_sync(kFull, mine, j);
      wj[j] = __shfl_sync(kFull, wm, j);
      dot[j] = 0.f;
    }
    const uint4* d = dout + static_cast<size_t>(m) * vecs;
    for (int v = lane; v < vecs; v += 32) {
      float df[8];
      unpack(__ldg(d + v), df);
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (pj[j] < 0) continue;
        uint4* row = dy + static_cast<size_t>(pj[j]) * vecs;
        float f[8], r[8];
        unpack(__ldg(y + static_cast<size_t>(pj[j]) * vecs + v), f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dot[j] = fmaf(df[i], f[i], dot[j]);
          r[i] = wj[j] * df[i];
        }
        row[v] = pack(r);
      }
    }
    float own = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      const float s = k3m::warp_sum(dot[j]);
      if (lane == j) own = s;
    }
    if (lane < k)
      dw[static_cast<size_t>(m) * k + lane] = mine >= 0 ? own : 0.f;
  }
}

// blocks for `work` rows at one row a warp, at most the card's resident grid
int grid_for(int work) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms <= 0)
    sms = 132;
  const int want = (work + kWarps - 1) / kWarps;
  return want < kBlocksPerSm * sms ? want : kBlocksPerSm * sms;
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

int done() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Sorted rows: `rows` (R) of them, the capacity; offs int32 [groups] the
// held experts' group ends (offs[groups - 1] = n); valid bool [R] (the
// gather's alone). Rows of
// vectors: `vecs` 16-byte vectors a row (a half of h's row in the SwiGLU
// kernels), tensors contiguous and 16-byte aligned. Each returns
// cudaGetLastError() after its launch (0 on success).

// x [R, vecs] = u [*, vecs][tok [R] int64], any dtype.
extern "C" int k3m_moe_gather(const void* u, const int64_t* tok, const int* offs, int groups,
                              const bool* valid, void* x, int rows, int vecs,
                              void* stream_ptr) {
  if (rows <= 0 || vecs <= 0 || groups <= 0 || misaligned(u) || misaligned(x))
    return cudaErrorInvalidValue;
  gather_kernel<<<grid_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const uint4*>(u), tok, offs, groups, valid, static_cast<uint4*>(x), rows,
      vecs);
  return done();
}

// a [R, 8 vecs] bf16 from h [R, 16 vecs] bf16.
extern "C" int k3m_moe_swiglu_fwd(const void* h, const int* offs, int groups, void* a,
                                  int rows, int vecs, void* stream_ptr) {
  if (rows <= 0 || vecs <= 0 || groups <= 0 || misaligned(h) || misaligned(a))
    return cudaErrorInvalidValue;
  swiglu_fwd_kernel<<<grid_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const uint4*>(h), offs, groups, static_cast<uint4*>(a), rows, vecs);
  return done();
}

// dh [R, 16 vecs] bf16 from h [R, 16 vecs] and da [R, 8 vecs] bf16.
extern "C" int k3m_moe_swiglu_bwd(const void* h, const void* da, const int* offs, int groups,
                                  void* dh, int rows, int vecs, void* stream_ptr) {
  if (rows <= 0 || vecs <= 0 || groups <= 0 || misaligned(h) || misaligned(da) ||
      misaligned(dh))
    return cudaErrorInvalidValue;
  swiglu_bwd_kernel<<<grid_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const uint4*>(h), static_cast<const uint4*>(da), offs, groups,
      static_cast<uint4*>(dh), rows, vecs);
  return done();
}

// out [N, 8 vecs] bf16 from y [R, 8 vecs] bf16, inv int64 [N k], w fp32 [N k]
// or null (every held pair weighs 1); R = pairs.
extern "C" int k3m_moe_combine_fwd(const void* y, const int64_t* inv, const float* w,
                                   const int* offs, int groups, void* out, int pairs,
                                   int rows, int k, int vecs, void* stream_ptr) {
  if (pairs <= 0 || rows <= 0 || vecs <= 0 || groups <= 0 || k <= 0 || k > kMaxK ||
      misaligned(y) || misaligned(out))
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (w != nullptr)
    combine_kernel<true><<<grid_for(rows), kThreads, 0, stream>>>(
        static_cast<const uint4*>(y), inv, w, offs, groups, static_cast<uint4*>(out), pairs,
        rows, k, vecs);
  else
    combine_kernel<false><<<grid_for(rows), kThreads, 0, stream>>>(
        static_cast<const uint4*>(y), inv, w, offs, groups, static_cast<uint4*>(out), pairs,
        rows, k, vecs);
  return done();
}

// dy [R, 8 vecs] bf16 and dw fp32 [N k] from dout [N, 8 vecs] bf16, y [R, 8
// vecs] bf16, inv int64 [N k] and w fp32 [N k].
extern "C" int k3m_moe_combine_bwd(const void* dout, const void* y, const int64_t* inv,
                                   const float* w, const int* offs, int groups, void* dy,
                                   float* dw, int pairs, int rows, int k, int vecs,
                                   void* stream_ptr) {
  if (pairs <= 0 || rows <= 0 || vecs <= 0 || groups <= 0 || k <= 0 || k > kMaxK ||
      misaligned(dout) || misaligned(y) || misaligned(dy))
    return cudaErrorInvalidValue;
  combine_bwd_kernel<<<grid_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const uint4*>(dout), static_cast<const uint4*>(y), inv, w, offs, groups,
      static_cast<uint4*>(dy), dw, pairs, rows, k, vecs);
  return done();
}
