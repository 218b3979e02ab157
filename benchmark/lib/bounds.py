"""The H100's published peaks and the least time each of the port's five
kernel functions could take for a call: the larger of its bytes (every
input read once, every output written once) over the memory bandwidth and
its operations over the tensor-core peak of its dtype. The bound reads the
work of the call, whatever kernel implements it."""

from __future__ import annotations

import math

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, 80 GB HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
BF16_PEAK = 989e12


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _size(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def bound_s(nbytes: float, flops: float, dtype) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS.get(dtype, PEAK_FLOPS[torch.float32]))


def layernorm_fwd(x, scale, bias, residual=None, out_dtype=None, with_rstd=False) -> float:
    """Residual add + LayerNorm over [rows, n]: x, residual, scale and bias
    in, the output (and, where a backward follows, the fp32 row rstd) out."""
    n = x.shape[-1]
    rows = x.numel() // n
    out = rows * n * _size(out_dtype or x.dtype)
    return bound_s(_nbytes(x, residual, scale, bias) + out + (4 * rows if with_rstd else 0),
                   0.0, x.dtype)


def layernorm_bwd(y, rstd, scale, bias, dy, x_dtype) -> float:
    """y, rstd, scale, bias and dy in; dx, dscale and dbias out."""
    n = y.shape[-1]
    rows = y.numel() // n
    return bound_s(_nbytes(y, rstd, scale, bias, dy) + rows * n * _size(x_dtype) + 8 * n,
                   0.0, y.dtype)


def _attn_flops(B, H, Lq, Lk, D) -> float:
    return 4.0 * B * H * Lq * Lk * D            # Q K^T and P V


def attention_fwd(q, k, v, bias, rate=0.0, for_backward=False) -> float:
    """q [B, Lq, H, D], k and v [B, Lk, H, D], bias [B, Lk] in; the output,
    and where a backward follows the fp32 row lse and (under dropout) one
    mask bit an element in whole 32-bit words, out."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    out = _nbytes(q)
    if for_backward:
        out += 4 * B * H * Lq + (4 * B * H * Lq * math.ceil(Lk / 32) if rate > 0 else 0)
    return bound_s(_nbytes(q, k, v, bias) + out, _attn_flops(B, H, Lq, Lk, D), q.dtype)


def attention_bwd(q, k, v, bias, out, lse, words, dout) -> float:
    """Everything the backward reads in, dq, dk and dv out; the operations
    of the recomputed scores and the four products of the backward."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    nbytes = _nbytes(q, k, v, bias, out, lse, words, dout) + _nbytes(q, k, v)
    return bound_s(nbytes, 10.0 * B * H * Lq * Lk * D, q.dtype)


def biattention_fwd(q1, k1, v1, bias1, q2, k2, v2, bias2, rate1=0.0, rate2=0.0,
                    for_backward=False) -> float:
    """Both directions of one co-attention call: ctx1 [B, L2, H, D] from
    q2 over stream 1's keys, ctx2 [B, L1, H, D] from q1 over stream 2's."""
    B, L1, H, D = q1.shape
    L2 = q2.shape[1]
    out = _nbytes(q1, q2)
    if for_backward:
        out += 4 * B * H * (L1 + L2)
        if rate1 > 0:
            out += 4 * B * H * L2 * math.ceil(L1 / 32)
        if rate2 > 0:
            out += 4 * B * H * L1 * math.ceil(L2 / 32)
    flops = _attn_flops(B, H, L2, L1, D) + _attn_flops(B, H, L1, L2, D)
    return bound_s(_nbytes(q1, k1, v1, bias1, q2, k2, v2, bias2) + out, flops, q1.dtype)
