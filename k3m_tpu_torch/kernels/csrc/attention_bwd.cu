// Fused attention backward: dQ, dK, dV of softmax(Q K^T / sqrt(D) + bias) V
// with dropout on the probabilities, recomputing the probabilities from the
// forward's fp32 row lse (no [Lq, Lk] probabilities are saved) and reading
// the dropout mask the forward stored, one bit per element.
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
// Bound on the H100: at the model's shapes the least work, 5 products of
// 2 Lq Lk D flops per (batch, head), is small next to the tensor cores, and
// the least time is the function's bytes: reading Q, K, V, dO and the bias
// once and writing dQ, dK, dV once (chip_smoke.py's `bound_ms`). This
// design also reads the forward's output O, fp32 row lse and mask words
// (`design_bound_ms`). The kernels run 8 products: the probabilities are
// rebuilt in both kernels, and the dQ kernel also sums P K (below).
//
// Design, after FlashAttention-2's split, with no atomics (the gradients
// are the same in every run):
//   kernel 1, one CTA per (query tile, head, batch), one pass over the
//     keys: P = exp(S - lse) with the forward's lse; dS' = P (dP - D'_i)
//     with D'_i = rowsum(dO * O) from the forward's output; it sums dS' K,
//     P K and the exact D_i = rowsum(dP * P) from the fp32 P and dP, as the
//     TPU kernel takes it, and writes dQ = (dS' K - (D_i - D'_i) P K) scale
//     and D_i. So the rounding of O in the model's dtype cannot stay in a
//     dS that cancels (rows of one key, where dS = 0);
//   kernel 2, one CTA per (key tile, head, batch): a loop over the query
//     tiles rebuilds P and dS with D_i and accumulates dK and dV in
//     registers.
// In bf16 every product runs on the tensor cores (attention_bwd_mma.cuh:
// ldmatrix fragments of one row-major tile per operand, a cp.async ring,
// dS and the dropped P rounded to bf16 for the mma, as FlashAttention-2
// does); fp32 keeps scalar fp32 FMAs from shared memory (cross-checks
// only). The dropout mask is the forward's: both dtypes read the words the
// forward stored (philox.cuh) and draw no random bits.
#include "attention_bwd_mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;                   // query rows per tile
constexpr int kKeys = 16;                   // keys per tile
constexpr int kLanes = kThreads / kRows;    // 8 threads per query row
static_assert(kKeys == 2 * kLanes, "each thread scores two keys of a tile");

using k3m::BwdArgs;

template <int D>
struct DqSmem {
  float q[kRows][D + 1];
  float dout[kRows][D + 1];
  float k[kKeys][D + 1];
  float v[kKeys][D + 1];
  float ds[kRows][kKeys + 1];   // dS' = P (dP - D'_i)
  float p[kRows][kKeys + 1];
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

// dropout factor of key k of row `row` (b, h, q): keep_scale or 0 from the
// forward's mask words, 1 without dropout
__device__ __forceinline__ float drop_factor(const BwdArgs& g, long long row, int k) {
  if (!g.f.keep_min) return 1.f;
  const int nwords = (g.f.lk + 31) / 32;
  return (g.keep_words[row * nwords + k / 32] >> (k & 31)) & 1u ? g.f.keep_scale : 0.f;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(BwdArgs g) {
  __shared__ DqSmem<D> s;
  constexpr int kCols = D / kLanes;
  const k3m::AttnArgs& a = g.f;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, r = tid / kLanes, c = tid % kLanes, qi = q0 + r;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dout = static_cast<const T*>(a.out) + b * a.o_sb + h * a.o_sh;
  const T* o = static_cast<const T*>(g.o) + b * g.o_sb + h * g.o_sh;
  const float* bias = a.bias + b * a.bias_sb;
  const long long row = (static_cast<long long>(b) * a.heads + h) * a.lq + qi;
  // the forward's lse (+inf past Lq: P = 0)
  const float lse = qi < a.lq ? g.lse[row] : INFINITY;

  load_rows<T, D>(s.q, q, a.q_sl, q0, a.lq);
  load_rows<T, D>(s.dout, dout, a.o_sl, q0, a.lq);
  __syncthreads();
  // D'_i = rowsum(dO * O) from the forward's output
  float da = 0.f;
  if (qi < a.lq)
    for (int d = c; d < D; d += kLanes) da += s.dout[r][d] * k3m::to_f32(o[qi * g.o_sl + d]);
  da = row_sum(da);

  // one pass: dQ' = dS' K, A = P K, D_i = rowsum(dP * P)
  float acc[kCols], pk[kCols], delta = 0.f;
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = pk[i] = 0.f;
  for (int k0 = 0; k0 < a.lk; k0 += kKeys) {
    __syncthreads();   // the previous tile is consumed
    load_rows<T, D>(s.k, k, a.k_sl, k0, a.lk);
    load_rows<T, D>(s.v, v, a.v_sl, k0, a.lk);
    if (tid < kKeys) s.bias[tid] = k0 + tid < a.lk ? bias[k0 + tid] : -INFINITY;
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = c + kLanes * u;
      float p = 0.f, ds = 0.f;
      if (k0 + j < a.lk && qi < a.lq) {
        p = expf(dot<D>(s.q[r], s.k[j]) * a.scale + s.bias[j] - lse);
        const float dp = dot<D>(s.dout[r], s.v[j]) * drop_factor(g, row, k0 + j);
        delta += p * dp;
        ds = p * (dp - da);
      }
      s.p[r][j] = p;
      s.ds[r][j] = ds;
    }
    __syncwarp();   // a row's 8 threads share one warp
    const int jn = min(kKeys, a.lk - k0);
    for (int j = 0; j < jn; ++j) {
      const float x = s.ds[r][j], y = s.p[r][j];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const float kv = s.k[j][c + kLanes * i];
        acc[i] = fmaf(x, kv, acc[i]);
        pk[i] = fmaf(y, kv, pk[i]);
      }
    }
  }
  delta = row_sum(delta);

  if (qi < a.lq) {
    T* dq = static_cast<T*>(g.dq) + ((static_cast<long long>(b) * a.lq + qi) * a.heads + h) * D;
    const float corr = delta - da;
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      dq[c + kLanes * i] = k3m::from_f32<T>((acc[i] - corr * pk[i]) * a.scale);
    if (c == 0) g.delta[row] = delta;
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
  const long long row0 = (static_cast<long long>(b) * a.heads + h) * a.lq;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dout = static_cast<const T*>(a.out) + b * a.o_sb + h * a.o_sh;
  const float* bias = a.bias + b * a.bias_sb;
  const float* lse = g.lse + row0;
  const float* delta = g.delta + row0;

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
        const float f = drop_factor(g, row0 + q0 + r, k0 + j);
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

// DV: the width of v, O and dO, D but for the latent-attention instance
// (q.k 192, v 128)
template <int D, int DV = D>
__global__ void __launch_bounds__(k3m::kMmaThreads) attn_bwd_dq_mma_kernel(BwdArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  k3m::attn_bwd_dq_mma<D, DV>(g, blockIdx.z, blockIdx.y, blockIdx.x * k3m::kMmaBQ,
                              *reinterpret_cast<k3m::DqMmaSmem<D, DV>*>(smem));
}

template <int D, int DV = D>
__global__ void __launch_bounds__(k3m::kMmaThreads) attn_bwd_dkv_mma_kernel(BwdArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  k3m::attn_bwd_dkv_mma<D, DV>(g, blockIdx.z, blockIdx.y, blockIdx.x * k3m::kMmaBQ,
                               *reinterpret_cast<k3m::DkvMmaSmem<D, DV>*>(smem));
}

// Both kernels take more shared memory than the 48 KB a launch gets
// without asking (dynamically): raise each kernel's limit, on the current
// device, at every launch (the call is cheap and nothing is cached).
template <int D, int DV = D>
cudaError_t allow_smem() {
  const cudaError_t e = cudaFuncSetAttribute(attn_bwd_dq_mma_kernel<D, DV>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             sizeof(k3m::DqMmaSmem<D, DV>));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(attn_bwd_dkv_mma_kernel<D, DV>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              sizeof(k3m::DkvMmaSmem<D, DV>));
}

template <int D, int DV = D>
int launch_mma(const BwdArgs& g, int B, int H, cudaStream_t stream) {
  const cudaError_t ok = allow_smem<D, DV>();
  if (ok != cudaSuccess) return static_cast<int>(ok);
  const dim3 grid_q((g.f.lq + k3m::kMmaBQ - 1) / k3m::kMmaBQ, H, B);
  const dim3 grid_k((g.f.lk + k3m::kMmaBQ - 1) / k3m::kMmaBQ, H, B);
  attn_bwd_dq_mma_kernel<D, DV>
      <<<grid_q, k3m::kMmaThreads, sizeof(k3m::DqMmaSmem<D, DV>), stream>>>(g);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dkv_mma_kernel<D, DV>
      <<<grid_k, k3m::kMmaThreads, sizeof(k3m::DkvMmaSmem<D, DV>), stream>>>(g);
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

// strides (elements): [q b,l,h, k b,l,h, v b,l,h, out b,l,h, dout b,l,h,
// bias_b]; `out` and `lse` ([B, H, Lq] fp32) are the forward's; dq, dk, dv
// are written contiguous [B, L, H, D] in the operands' dtype; delta is fp32
// [B, H, Lq] scratch; keep_words is the forward's dropout mask, uint32
// [B, H, Lq, ceil(Lk / 32)], needed under dropout (keep_min > 0, the
// forward's; keep_scale its 1 / (1 - rate)).
// Returns cudaGetLastError() after the launches (0 on success).
namespace {

BwdArgs make_bwd_args(const void* q, const void* k, const void* v, const float* bias,
                      const void* out, const float* lse, const uint32_t* keep_words,
                      const void* dout, void* dq, void* dk, void* dv, float* delta, int H,
                      int lq, int lk, const long long* st, float scale, unsigned keep_min,
                      float keep_scale) {
  const long long fst[13] = {st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                             st[8], st[12], st[13], st[14], st[15]};
  BwdArgs g;
  g.f = k3m::make_args(q, k, v, bias, const_cast<void*>(dout), fst, lq, lk, H, scale,
                       0u, keep_min, keep_scale);
  g.o = out;
  g.o_sb = st[9];
  g.o_sl = st[10];
  g.o_sh = st[11];
  g.lse = lse;
  g.delta = delta;
  g.keep_words = keep_words;
  g.dq = dq;
  g.dk = dk;
  g.dv = dv;
  return g;
}

// the tensor cores read 16-byte rows; the wrapper refuses other layouts
bool mma_ready(const BwdArgs& g, const void* out, const void* dq, const void* dk,
               const void* dv) {
  return k3m::mma_aligned(g.f) && !(reinterpret_cast<uintptr_t>(out) % 16 || g.o_sb % 8 ||
                                    g.o_sl % 8 || g.o_sh % 8 ||
                                    reinterpret_cast<uintptr_t>(dq) % 16 ||
                                    reinterpret_cast<uintptr_t>(dk) % 16 ||
                                    reinterpret_cast<uintptr_t>(dv) % 16);
}

}  // namespace

extern "C" int k3m_attention_bwd(const void* q, const void* k, const void* v,
                                 const float* bias, const void* out, const float* lse,
                                 const uint32_t* keep_words, const void* dout, void* dq,
                                 void* dk, void* dv, float* delta, int dtype, int B, int H,
                                 int lq, int lk, int d, const long long* strides,
                                 float scale, unsigned keep_min, float keep_scale,
                                 void* stream_ptr) {
  if (B <= 0 || H <= 0 || lq <= 0 || lk <= 0 || B > 65535 || H > 65535 ||
      (keep_min && keep_words == nullptr))
    return cudaErrorInvalidValue;
  const BwdArgs g = make_bwd_args(q, k, v, bias, out, lse, keep_words, dout, dq, dk, dv, delta,
                                  H, lq, lk, strides, scale, keep_min, keep_scale);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == k3m::kF32) return launch_d_f32(g, B, H, d, stream);
  // bf16 runs on the tensor cores only, which read 16-byte rows; the wrapper
  // refuses other layouts, as the forward's does
  if (!mma_ready(g, out, dq, dk, dv)) return cudaErrorInvalidValue;
  return launch_d_mma(g, B, H, d, stream);
}

// The latent-attention instance: q, k, dq and dk `dk_width` wide, v, out,
// dout and dv `dv_width` wide (192 and 128), bf16 only; otherwise the
// arguments of k3m_attention_bwd, `scale` the forward's.
extern "C" int k3m_attention_bwd_split(const void* q, const void* k, const void* v,
                                       const float* bias, const void* out, const float* lse,
                                       const uint32_t* keep_words, const void* dout, void* dq,
                                       void* dk, void* dv, float* delta, int B, int H, int lq,
                                       int lk, int dk_width, int dv_width,
                                       const long long* strides, float scale,
                                       unsigned keep_min, float keep_scale, void* stream_ptr) {
  if (B <= 0 || H <= 0 || lq <= 0 || lk <= 0 || B > 65535 || H > 65535 ||
      (keep_min && keep_words == nullptr) || dk_width != 192 || dv_width != 128)
    return cudaErrorInvalidValue;
  const BwdArgs g = make_bwd_args(q, k, v, bias, out, lse, keep_words, dout, dq, dk, dv, delta,
                                  H, lq, lk, strides, scale, keep_min, keep_scale);
  if (!mma_ready(g, out, dq, dk, dv)) return cudaErrorInvalidValue;
  return launch_mma<192, 128>(g, B, H, static_cast<cudaStream_t>(stream_ptr));
}
