// Device code of one attention tile, shared by the self-attention kernel
// (attention.cu) and the bi-directional co-attention kernel (coattn.cu).
//
// One CTA of 128 threads owns kBQ = 16 query rows of one (batch, head) and
// streams the keys in tiles of kBK = 32 through shared memory with an online
// softmax (running max m, running sum l, rescaled accumulator), so nothing
// of shape [Lq, Lk] ever reaches device memory and fp32 K/V tiles fit at
// D = 128. Eight threads serve one query row: each computes 4 of the
// tile's 32 scores and owns D/8 output columns (d = lane + 8 i), so the
// row's max and sum are 3-step shuffles inside an 8-lane group. Shared rows
// are padded to D + 1 floats so the score loop reads 8 distinct keys
// without bank conflicts. Ragged Lk is masked in the kernel (keys past Lk
// score -inf); query rows past Lq are computed on zeros and not stored.
//
// Operands are addressed through (batch, seq, head) strides with a unit
// stride over D, so the model's [B, L, H, D] projections go in without a
// transpose. Inner products are scalar fp32 FMAs; the softmax is fp32, as
// in the Pallas kernel (scores are not rounded to the compute dtype).
//
// Dropout on the probabilities (keep_min > 0): the running sum l takes the
// undropped probabilities, the P V product the dropped ones (Philox mask of
// philox.cuh), and the output is scaled by keep_scale / l at the end, which
// is softmax, then `probs * keep / (1 - rate)`, then the product with V.
// A key tile is one 32-bit mask word per row: lane c draws keys 4c..4c+3
// with one Philox call, the row's 8 lanes OR their nibbles together, and
// where `keep_words` is given lane 0 stores the word for the backward.
//
// Where the backward will need it (a non-null `lse`), the tile also writes
// each row's fp32 log-sum-exp m + log l of the scaled, biased scores
// ([B, H, Lq]), from the statistics it already keeps: the backward then
// rebuilds P = exp(S - lse) in one pass. The serving path passes null.
#pragma once

#include <math.h>

#include "common.cuh"
#include "philox.cuh"

namespace k3m {

constexpr int kAttnThreads = 128;
constexpr int kBQ = 16;                           // query rows per CTA
constexpr int kBK = 32;                           // keys per shared tile
constexpr int kRowLanes = kAttnThreads / kBQ;     // 8 threads per query row
constexpr int kScoresPerLane = kBK / kRowLanes;   // 4

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [B, Lk] additive key bias, fp32
  void* out;
  long long q_sb, q_sl, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long o_sb, o_sl, o_sh;
  long long bias_sb;
  int lq, lk, heads;
  float scale;
  uint32_t seed;      // Philox key word 0: the call's seed plus the salt
  uint32_t keep_min;  // keep iff (bits >> 8) >= keep_min; 0 = no dropout
  float keep_scale;   // 1 / (1 - rate)
  float* lse;         // [B, H, Lq] row log-sum-exp out, or null
  uint32_t* keep_words;  // [B, H, Lq, ceil(Lk / 32)] dropout mask out, or null
};

template <int D>
struct AttnSmem {
  float q[kBQ][D + 1];
  float k[kBK][D + 1];
  float v[kBK][D + 1];
  float p[kBQ][kBK + 1];
  float bias[kBK];
};

template <typename T, int D>
__device__ __forceinline__ void attn_tile(const AttnArgs& a, int b, int h, int q0,
                                          AttnSmem<D>& s) {
  static_assert(D % kRowLanes == 0, "head dim must be a multiple of 8");
  static_assert(kBK == 32 && 4 * kRowLanes == kBK, "a key tile is one mask word per row");
  constexpr int kCols = D / kRowLanes;
  const int tid = threadIdx.x;
  const int r = tid / kRowLanes;
  const int c = tid % kRowLanes;
  const long long row = (static_cast<long long>(b) * a.heads + h) * a.lq + q0 + r;
  const int nwords = (a.lk + 31) / 32;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* bias = a.bias + b * a.bias_sb;

  for (int idx = tid; idx < kBQ * D; idx += kAttnThreads) {
    const int rr = idx / D, d = idx % D, qi = q0 + rr;
    s.q[rr][d] = qi < a.lq ? to_f32(q[qi * a.q_sl + d]) : 0.f;
  }

  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < a.lk; k0 += kBK) {
    __syncthreads();  // Q is loaded; the previous K/V/P tile is consumed
    for (int idx = tid; idx < kBK * D; idx += kAttnThreads) {
      const int j = idx / D, d = idx % D, kj = k0 + j;
      const bool ok = kj < a.lk;
      s.k[j][d] = ok ? to_f32(k[kj * a.k_sl + d]) : 0.f;
      s.v[j][d] = ok ? to_f32(v[kj * a.v_sl + d]) : 0.f;
    }
    if (tid < kBK) s.bias[tid] = k0 + tid < a.lk ? bias[k0 + tid] : -INFINITY;
    __syncthreads();

    float sc[kScoresPerLane];
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < kScoresPerLane; ++i) {
      const int j = c + kRowLanes * i;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(s.q[r][d], s.k[j][d], dot);
      const float x = k0 + j < a.lk ? dot * a.scale + s.bias[j] : -INFINITY;
      sc[i] = x;
      tmax = fmaxf(tmax, x);
    }
#pragma unroll
    for (int off = kRowLanes / 2; off > 0; off >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    // every tile holds at least one real key, so m_new is finite
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    uint32_t kw = 0;   // bit j keeps key k0 + j
    if (a.keep_min) {
      kw = keep_bits4(a.seed, b * a.heads + h, q0 + r, k0 + 4 * c, a.keep_min) << (4 * c);
#pragma unroll
      for (int off = 1; off < kRowLanes; off <<= 1) kw |= __shfl_xor_sync(0xffffffffu, kw, off);
      if (a.keep_words != nullptr && c == 0 && q0 + r < a.lq)
        a.keep_words[row * nwords + k0 / 32] = kw;
    }
    float tsum = 0.f;
#pragma unroll
    for (int i = 0; i < kScoresPerLane; ++i) {
      const float p = expf(sc[i] - m_new);
      const int j = c + kRowLanes * i;
      s.p[r][j] = a.keep_min ? p * static_cast<float>((kw >> j) & 1u) : p;
      tsum += p;
    }
#pragma unroll
    for (int off = kRowLanes / 2; off > 0; off >>= 1)
      tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
    l = l * alpha + tsum;
    m = m_new;
    __syncwarp();  // a row's 8 threads share one warp: P row is visible

#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] *= alpha;
    const int jn = min(kBK, a.lk - k0);
    for (int j = 0; j < jn; ++j) {
      const float p = s.p[r][j];
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[i] = fmaf(p, s.v[j][c + kRowLanes * i], acc[i]);
    }
  }

  const int qi = q0 + r;
  if (qi < a.lq) {
    T* o = static_cast<T*>(a.out) + b * a.o_sb + qi * a.o_sl + h * a.o_sh;
    const float inv = (a.keep_min ? a.keep_scale : 1.f) / l;
#pragma unroll
    for (int i = 0; i < kCols; ++i) o[c + kRowLanes * i] = from_f32<T>(acc[i] * inv);
    if (a.lse != nullptr && c == 0) a.lse[row] = m + logf(l);
  }
}

// Fills an AttnArgs from the C interface's stride array:
// [q_b, q_l, q_h, k_b, k_l, k_h, v_b, v_l, v_h, o_b, o_l, o_h, bias_b].
inline AttnArgs make_args(const void* q, const void* k, const void* v,
                          const float* bias, void* out, const long long* st,
                          int lq, int lk, int heads, float scale, uint32_t seed,
                          uint32_t keep_min, float keep_scale) {
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.bias = bias; a.out = out;
  a.q_sb = st[0]; a.q_sl = st[1]; a.q_sh = st[2];
  a.k_sb = st[3]; a.k_sl = st[4]; a.k_sh = st[5];
  a.v_sb = st[6]; a.v_sl = st[7]; a.v_sh = st[8];
  a.o_sb = st[9]; a.o_sl = st[10]; a.o_sh = st[11];
  a.bias_sb = st[12];
  a.lq = lq; a.lk = lk; a.heads = heads; a.scale = scale;
  a.seed = seed; a.keep_min = keep_min; a.keep_scale = keep_scale;
  a.lse = nullptr;
  a.keep_words = nullptr;
  return a;
}

}  // namespace k3m
