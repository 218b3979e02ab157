// Fused attention backward: dQ, dK, dV of softmax(Q K^T / sqrt(D) + bias) V
// with dropout on the probabilities, recomputing the probabilities and the
// dropout mask instead of reading them (nothing [Lq, Lk]-shaped is stored).
//
// Replaces: k3m_tpu/kernels/attention.py:_attn_bwd_kernel (called from
// _fused_attention_bwd_call), and, once per direction with the forward's
// seeds, the co-attention backward (coattn.py:178-192). Its formulas:
//   P  = softmax(S),  S = Q K^T scale + bias,  P~ = P * keep / (1 - rate)
//   dV = P~^T dO
//   dP = (dO V^T) * keep / (1 - rate)
//   dS = P * (dP - rowsum(dP * P))
//   dQ = dS K scale,  dK = dS^T Q scale;  no gradient for the bias.
//
// Bound on the H100: at the model's shapes the work (5 products of
// 2 Lq Lk D flops per (batch, head)) is small next to the tensor cores, and
// the least time is reading Q, K, V, dO once and writing dQ, dK, dV once.
// In fp32 both kernels run scalar fp32 FMAs from shared memory; in bf16
// every product runs on the tensor cores (attention_bwd_mma.cuh), with dS
// and the dropped P rounded to bf16 for the mma, as FlashAttention-2 does.
// The TPU kernel holds one (batch, head) in VMEM; at Lk 256 and
// D 128 the fp32 dK/dV accumulators of a whole head do not fit a CTA, so the
// work is split as FlashAttention-2 splits it, with no atomics (the
// gradients are deterministic):
//   kernel 1, one CTA per (query tile of 16 rows, head, batch): three passes
//     over the keys give the row max and sum (then lse = m + log l), the
//     row sums D_i = rowsum(dP * P) from the recomputed P (as the TPU kernel
//     does), and dQ; it writes dQ, lse and D_i;
//   kernel 2, one CTA per (key tile of 16 keys, head, batch): a loop over
//     the query tiles rebuilds P = exp(S - lse) and dS and accumulates dK
//     and dV in registers.
// Both kernels regenerate the forward's Philox mask (philox.cuh).
#include "attention_bwd_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;                   // query rows per tile
constexpr int kKeys = 16;                   // keys per tile
constexpr int kLanes = kThreads / kRows;    // 8 threads per query row
static_assert(kKeys == 2 * kLanes, "each thread scores two keys of a tile");

struct BwdArgs {
  k3m::AttnArgs f;      // q, k, v, bias; f.out and its strides are dO
  void* dq;             // contiguous [B, Lq, H, D]
  void* dk;             // contiguous [B, Lk, H, D]
  void* dv;
  float* lse;           // [B, H, Lq] scratch
  float* delta;         // [B, H, Lq] scratch
};

template <int D>
struct DqSmem {
  float q[kRows][D + 1];
  float dout[kRows][D + 1];
  float k[kKeys][D + 1];
  float v[kKeys][D + 1];
  float ds[kRows][kKeys + 1];
  float bias[kKeys];
};

template <int D>
struct DkvSmem {
  float k[kKeys][D + 1];
  float v[kKeys][D + 1];
  float q[kRows][D + 1];
  float dout[kRows][D + 1];
  float p[kRows][kKeys + 1];    // dropped probabilities P~
  float ds[kRows][kKeys + 1];
  float lse[kRows];
  float delta[kRows];
  float bias[kKeys];
};

template <int D>
__device__ __forceinline__ float dot(const float (&a)[D + 1], const float (&b)[D + 1]) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [r0, r0 + kRows) of a [L, D] operand at `base` with row stride `sl`
// into shared memory, zeros past `n`
template <typename T, int D>
__device__ __forceinline__ void load_rows(float (*dst)[D + 1], const T* base, long long sl,
                                          int r0, int n) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int rr = idx / D, d = idx % D, r = r0 + rr;
    dst[rr][d] = r < n ? k3m::to_f32(base[r * sl + d]) : 0.f;
  }
}

// dropout factor of element (q, k): keep_scale or 0, 1 without dropout
__device__ __forceinline__ float drop_factor(const k3m::AttnArgs& a, uint32_t bh, int q, int k) {
  if (!a.keep_min) return 1.f;
  return k3m::keep(a.seed, bh, q, k, a.keep_min) * a.keep_scale;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(BwdArgs g) {
  __shared__ DqSmem<D> s;
  constexpr int kCols = D / kLanes;
  const k3m::AttnArgs& a = g.f;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, r = tid / kLanes, c = tid % kLanes, qi = q0 + r;
  const uint32_t bh = b * a.heads + h;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dout = static_cast<const T*>(a.out) + b * a.o_sb + h * a.o_sh;
  const float* bias = a.bias + b * a.bias_sb;

  load_rows<T, D>(s.q, q, a.q_sl, q0, a.lq);
  load_rows<T, D>(s.dout, dout, a.o_sl, q0, a.lq);

  // the score of key j of the tile at k0 (-inf past Lk); K and bias in smem
  auto score = [&](int k0, int j) {
    return k0 + j < a.lk ? dot<D>(s.q[r], s.k[j]) * a.scale + s.bias[j] : -INFINITY;
  };
  auto load_tile = [&](int k0, bool with_v) {
    __syncthreads();   // the previous tile is consumed
    load_rows<T, D>(s.k, k, a.k_sl, k0, a.lk);
    if (with_v) load_rows<T, D>(s.v, v, a.v_sl, k0, a.lk);
    if (tid < kKeys) s.bias[tid] = k0 + tid < a.lk ? bias[k0 + tid] : -INFINITY;
    __syncthreads();
  };

  // pass 1: row max and sum (every tile holds a real key: m stays finite)
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < a.lk; k0 += kKeys) {
    load_tile(k0, false);
    const float x0 = score(k0, c), x1 = score(k0, c + kLanes);
    const float mn = fmaxf(m, row_max(fmaxf(x0, x1)));
    l = l * expf(m - mn) + row_sum(expf(x0 - mn) + expf(x1 - mn));
    m = mn;
  }
  const float inv_l = 1.f / l;

  // pass 2: D_i = rowsum(dP * P), dP with the dropout factor
  float delta = 0.f;
  for (int k0 = 0; k0 < a.lk; k0 += kKeys) {
    load_tile(k0, true);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = c + kLanes * u;
      if (k0 + j < a.lk) {
        const float p = expf(score(k0, j) - m) * inv_l;
        delta += p * dot<D>(s.dout[r], s.v[j]) * drop_factor(a, bh, qi, k0 + j);
      }
    }
  }
  delta = row_sum(delta);

  // pass 3: dS = P (dP - D_i), dQ = dS K
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < a.lk; k0 += kKeys) {
    load_tile(k0, true);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = c + kLanes * u;
      float ds = 0.f;
      if (k0 + j < a.lk) {
        const float p = expf(score(k0, j) - m) * inv_l;
        const float dp = dot<D>(s.dout[r], s.v[j]) * drop_factor(a, bh, qi, k0 + j);
        ds = p * (dp - delta);
      }
      s.ds[r][j] = ds;
    }
    __syncwarp();   // a row's 8 threads share one warp
    const int jn = min(kKeys, a.lk - k0);
    for (int j = 0; j < jn; ++j) {
      const float x = s.ds[r][j];
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = fmaf(x, s.k[j][c + kLanes * i], acc[i]);
    }
  }

  if (qi < a.lq) {
    T* dq = static_cast<T*>(g.dq) + ((static_cast<long long>(b) * a.lq + qi) * a.heads + h) * D;
#pragma unroll
    for (int i = 0; i < kCols; ++i) dq[c + kLanes * i] = k3m::from_f32<T>(acc[i] * a.scale);
    if (c == 0) {
      const long long row = (static_cast<long long>(b) * a.heads + h) * a.lq + qi;
      g.lse[row] = m + logf(l);
      g.delta[row] = delta;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkv_kernel(BwdArgs g) {
  __shared__ DkvSmem<D> s;
  constexpr int kCols = D / kLanes;
  const k3m::AttnArgs& a = g.f;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kKeys;
  const int tid = threadIdx.x;
  const int r = tid / kLanes, c = tid % kLanes;   // scoring: query row r, keys c, c + 8
  const int jk = tid / kLanes;                    // accumulating: key jk, columns c + 8 i
  const uint32_t bh = b * a.heads + h;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dout = static_cast<const T*>(a.out) + b * a.o_sb + h * a.o_sh;
  const float* bias = a.bias + b * a.bias_sb;
  const float* lse = g.lse + (static_cast<long long>(b) * a.heads + h) * a.lq;
  const float* delta = g.delta + (static_cast<long long>(b) * a.heads + h) * a.lq;

  load_rows<T, D>(s.k, k, a.k_sl, k0, a.lk);
  load_rows<T, D>(s.v, v, a.v_sl, k0, a.lk);
  if (tid < kKeys) s.bias[tid] = k0 + tid < a.lk ? bias[k0 + tid] : -INFINITY;

  float dk[kCols], dv[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) dk[i] = dv[i] = 0.f;

  for (int q0 = 0; q0 < a.lq; q0 += kRows) {
    __syncthreads();   // K/V loaded; the previous query tile is consumed
    load_rows<T, D>(s.q, q, a.q_sl, q0, a.lq);
    load_rows<T, D>(s.dout, dout, a.o_sl, q0, a.lq);
    if (tid < kRows) {
      // rows past Lq: lse +inf gives P = 0, so they add nothing
      s.lse[tid] = q0 + tid < a.lq ? lse[q0 + tid] : INFINITY;
      s.delta[tid] = q0 + tid < a.lq ? delta[q0 + tid] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = c + kLanes * u;
      float pd = 0.f, ds = 0.f;
      if (k0 + j < a.lk && q0 + r < a.lq) {
        const float p = expf(dot<D>(s.q[r], s.k[j]) * a.scale + s.bias[j] - s.lse[r]);
        const float f = drop_factor(a, bh, q0 + r, k0 + j);
        pd = p * f;
        ds = p * (dot<D>(s.dout[r], s.v[j]) * f - s.delta[r]);
      }
      s.p[r][j] = pd;
      s.ds[r][j] = ds;
    }
    __syncthreads();
    const int rn = min(kRows, a.lq - q0);
    for (int i = 0; i < rn; ++i) {
      const float pd = s.p[i][jk], ds = s.ds[i][jk];
#pragma unroll
      for (int x = 0; x < kCols; ++x) {
        const int d = c + kLanes * x;
        dv[x] = fmaf(pd, s.dout[i][d], dv[x]);
        dk[x] = fmaf(ds, s.q[i][d], dk[x]);
      }
    }
  }

  const int kj = k0 + jk;
  if (kj < a.lk) {
    const long long off = ((static_cast<long long>(b) * a.lk + kj) * a.heads + h) * D;
    T* dkp = static_cast<T*>(g.dk) + off;
    T* dvp = static_cast<T*>(g.dv) + off;
#pragma unroll
    for (int x = 0; x < kCols; ++x) {
      dkp[c + kLanes * x] = k3m::from_f32<T>(dk[x] * a.scale);
      dvp[c + kLanes * x] = k3m::from_f32<T>(dv[x]);
    }
  }
}

template <typename T, int D>
int launch(const BwdArgs& g, int B, int H, cudaStream_t stream) {
  const dim3 grid_q((g.f.lq + kRows - 1) / kRows, H, B);
  const dim3 grid_k((g.f.lk + kKeys - 1) / kKeys, H, B);
  attn_bwd_dq_kernel<T, D><<<grid_q, kThreads, 0, stream>>>(g);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dkv_kernel<T, D><<<grid_k, kThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
__global__ void __launch_bounds__(k3m::kMmaThreads) attn_bwd_dq_mma_kernel(BwdArgs g) {
  __shared__ k3m::DqMmaSmem<D> s;
  k3m::attn_bwd_dq_mma<D>(g.f, blockIdx.z, blockIdx.y, blockIdx.x * k3m::kMmaBQ,
                          static_cast<__nv_bfloat16*>(g.dq), g.lse, g.delta, s);
}

template <int D>
__global__ void __launch_bounds__(k3m::kMmaThreads) attn_bwd_dkv_mma_kernel(BwdArgs g) {
  __shared__ k3m::DkvMmaSmem<D> s;
  k3m::attn_bwd_dkv_mma<D>(g.f, blockIdx.z, blockIdx.y, blockIdx.x * k3m::kMmaBQ,
                           static_cast<__nv_bfloat16*>(g.dk), static_cast<__nv_bfloat16*>(g.dv),
                           g.lse, g.delta, s);
}

template <int D>
int launch_mma(const BwdArgs& g, int B, int H, cudaStream_t stream) {
  const dim3 grid_q((g.f.lq + k3m::kMmaBQ - 1) / k3m::kMmaBQ, H, B);
  const dim3 grid_k((g.f.lk + k3m::kMmaBQ - 1) / k3m::kMmaBQ, H, B);
  attn_bwd_dq_mma_kernel<D><<<grid_q, k3m::kMmaThreads, 0, stream>>>(g);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dkv_mma_kernel<D><<<grid_k, k3m::kMmaThreads, 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

int launch_d_mma(const BwdArgs& g, int B, int H, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_mma<64>(g, B, H, stream);
    case 96: return launch_mma<96>(g, B, H, stream);
    case 128: return launch_mma<128>(g, B, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the scalar kernels run fp32 only
int launch_d_f32(const BwdArgs& g, int B, int H, int d, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<float, 64>(g, B, H, stream);
    case 96: return launch<float, 96>(g, B, H, stream);
    case 128: return launch<float, 128>(g, B, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides (elements): [q b,l,h, k b,l,h, v b,l,h, dout b,l,h, bias_b]; dq,
// dk, dv are written contiguous [B, L, H, D] in the operands' dtype; lse and
// delta are fp32 [B, H, Lq] scratch. seed/keep_min/keep_scale are those of
// the forward call (direction 2 of the co-attention: seed + 7919). Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int k3m_attention_bwd(const void* q, const void* k, const void* v,
                                 const float* bias, const void* dout, void* dq,
                                 void* dk, void* dv, float* lse, float* delta,
                                 int dtype, int B, int H, int lq, int lk, int d,
                                 const long long* strides, float scale,
                                 unsigned seed, unsigned keep_min, float keep_scale,
                                 void* stream_ptr) {
  if (B <= 0 || H <= 0 || lq <= 0 || lk <= 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  BwdArgs g;
  g.f = k3m::make_args(q, k, v, bias, const_cast<void*>(dout), strides, lq, lk, H, scale,
                       seed, keep_min, keep_scale);
  g.dq = dq;
  g.dk = dk;
  g.dv = dv;
  g.lse = lse;
  g.delta = delta;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == k3m::kF32) return launch_d_f32(g, B, H, d, stream);
  // bf16 runs on the tensor cores only, which read 16-byte rows; the wrapper
  // refuses other layouts, as the forward's does
  if (!k3m::mma_aligned(g.f) || reinterpret_cast<uintptr_t>(dq) % 16 ||
      reinterpret_cast<uintptr_t>(dk) % 16 || reinterpret_cast<uintptr_t>(dv) % 16)
    return cudaErrorInvalidValue;
  return launch_d_mma(g, B, H, d, stream);
}
