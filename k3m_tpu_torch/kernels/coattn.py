"""Fused bi-directional co-attention, forward and backward, with dropout:
CUDA kernels and plain versions.

Stream 1 gives (q1, k1, v1, bias1) [B, L1, H, D], stream 2 gives
(q2, k2, v2, bias2) [B, L2, H, D]; the result is, in the order of
k3m_tpu/kernels/coattn.py:_biattn_kernel,
  ctx1 = softmax(q2 k1^T / sqrt(D) + bias1) v1   [B, L2, H, D]
  ctx2 = softmax(q1 k2^T / sqrt(D) + bias2) v2   [B, L1, H, D]
Each bias belongs to the KEY side of its direction. `dropout1` drops the
probabilities over stream 1's values, `dropout2` those over stream 2's;
direction 1 draws its Philox mask from `seed`, direction 2 from
`seed + 7919` (the TPU kernel's salts). The backward is the attention
backward once per direction, with the same seeds (coattn.py:178-192).
"""

from __future__ import annotations

import math

import torch

from k3m_tpu_torch.kernels import build
from k3m_tpu_torch.kernels.attention import (
    U32, _device_kind, _plain_keep, attention_bwd, attention_plain, bld_strides,
    check_operands, keep_threshold,
)

SALT2 = 7919


def biattention_plain(q1, k1, v1, bias1, q2, k2, v2, bias2, keep1=None,
                      keep2=None, dropout1: float = 0.0, dropout2: float = 0.0):
    return (attention_plain(q2, k1, v1, bias1, keep1, dropout1),
            attention_plain(q1, k2, v2, bias2, keep2, dropout2))


def _forward(q1, k1, v1, bias1, q2, k2, v2, bias2, dropout1, dropout2, seed):
    if _device_kind(q1, "fused_biattention") == "cpu":
        return biattention_plain(
            q1, k1, v1, bias1, q2, k2, v2, bias2,
            _plain_keep(q2, k1, dropout1, seed, 0),
            _plain_keep(q1, k2, dropout2, seed, SALT2), dropout1, dropout2)
    check_operands(q2, k1, v1, bias1, "fused_biattention (direction 1)")
    check_operands(q1, k2, v2, bias2, "fused_biattention (direction 2)")
    B, L1, H, D = q1.shape
    L2 = q2.shape[1]
    if q1.dtype != q2.dtype or q1.device != q2.device or k1.shape[1] != L1:
        raise ValueError("fused_biattention: streams differ in dtype, device or length")
    min1, scale1 = keep_threshold(dropout1)
    min2, scale2 = keep_threshold(dropout2)
    out1 = torch.empty((B, L2, H, D), dtype=q1.dtype, device=q1.device)
    out2 = torch.empty((B, L1, H, D), dtype=q1.dtype, device=q1.device)
    strides = build.int64_array(
        bld_strides(q1) + bld_strides(k1) + bld_strides(v1)
        + bld_strides(q2) + bld_strides(k2) + bld_strides(v2)
        + bld_strides(out1) + bld_strides(out2)
        + [bias1.stride(0), bias2.stride(0)])
    rc = build.library().k3m_biattention_fwd(
        q1.data_ptr(), k1.data_ptr(), v1.data_ptr(), bias1.data_ptr(),
        q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), bias2.data_ptr(),
        out1.data_ptr(), out2.data_ptr(), build.DTYPE_CODES[q1.dtype],
        B, H, L1, L2, D, strides, 1.0 / math.sqrt(D), seed & U32,
        min1, scale1, min2, scale2, build.stream_handle(q1.device))
    build.check(rc, "k3m_biattention_fwd")
    fused_biattention.launches += 1
    return out1, out2


class _FusedBiAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q1, k1, v1, bias1, q2, k2, v2, bias2, dropout1, dropout2, seed):
        ctx.save_for_backward(q1, k1, v1, bias1, q2, k2, v2, bias2)
        ctx.rates, ctx.seed = (dropout1, dropout2), seed
        return _forward(q1, k1, v1, bias1, q2, k2, v2, bias2, dropout1, dropout2, seed)

    @staticmethod
    def backward(ctx, dctx1, dctx2):
        q1, k1, v1, bias1, q2, k2, v2, bias2 = ctx.saved_tensors
        r1, r2 = ctx.rates
        dq2, dk1, dv1 = attention_bwd(q2, k1, v1, bias1, dctx1, r1, ctx.seed, 0)
        dq1, dk2, dv2 = attention_bwd(q1, k2, v2, bias2, dctx2, r2, ctx.seed, SALT2)
        return dq1, dk1, dv1, None, dq2, dk2, dv2, None, None, None, None


def fused_biattention(q1, k1, v1, bias1, q2, k2, v2, bias2, *,
                      dropout1: float = 0.0, dropout2: float = 0.0, seed: int = 0):
    """(ctx1, ctx2) as above; differentiable in the six projections."""
    keep_threshold(dropout1)
    keep_threshold(dropout2)
    args = (q1, k1, v1, bias1, q2, k2, v2, bias2)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q1, k1, v1, q2, k2, v2)):
        return _FusedBiAttention.apply(*args, dropout1, dropout2, seed)
    return _forward(*args, dropout1, dropout2, seed)


fused_biattention.launches = 0
