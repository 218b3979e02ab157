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
`seed + 7919` (the TPU kernel's salts), both keyed by the global row
and the global head (`row0` + b, `head0` + h of `heads_global`,
attention.py). The backward is the attention
backward once per direction (coattn.py:178-192), fed what the forward
keeps for each direction: its output, its row log-sum-exp and (under
dropout) its mask words.
"""

from __future__ import annotations

import math

import torch

from k3m_tpu_torch.kernels import build
from k3m_tpu_torch.kernels.attention import (
    U32, _device_kind, _plain_forward, _ptr, attention_bwd, attention_plain, bld_strides,
    check_mask_key, check_operands, keep_threshold, keep_words_for,
)
from k3m_tpu_torch.utils import trace

SALT2 = 7919


def biattention_plain(q1, k1, v1, bias1, q2, k2, v2, bias2, keep1=None,
                      keep2=None, dropout1: float = 0.0, dropout2: float = 0.0):
    return (attention_plain(q2, k1, v1, bias1, keep1, dropout1),
            attention_plain(q1, k2, v2, bias2, keep2, dropout2))


@trace.spanned("k3m.kernel.fused_biattention", arguments=True)
def _forward(q1, k1, v1, bias1, q2, k2, v2, bias2, dropout1, dropout2, seed,
             for_backward=False, row0=0, head0=0, heads_global=None):
    """(out1, out2, kept1, kept2): each direction's (lse, keep_words) as
    attention._forward keeps them (lse1 [B, H, L2], lse2 [B, H, L1]; on the
    CPU lse None), where a backward will read them, else (None, None)."""
    if _device_kind(q1, "fused_biattention") == "cpu":
        out1, *kept1 = _plain_forward(q2, k1, v1, bias1, dropout1, seed, 0, for_backward,
                                      row0, head0, heads_global)
        out2, *kept2 = _plain_forward(q1, k2, v2, bias2, dropout2, seed, SALT2, for_backward,
                                      row0, head0, heads_global)
        return out1, out2, tuple(kept1), tuple(kept2)
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
    lse1 = lse2 = words1 = words2 = None
    if for_backward:
        lse1 = torch.empty((B, H, L2), dtype=torch.float32, device=q1.device)
        lse2 = torch.empty((B, H, L1), dtype=torch.float32, device=q1.device)
        words1 = keep_words_for(q2, L1, dropout1)
        words2 = keep_words_for(q1, L2, dropout2)
    strides = build.int64_array(
        bld_strides(q1) + bld_strides(k1) + bld_strides(v1)
        + bld_strides(q2) + bld_strides(k2) + bld_strides(v2)
        + bld_strides(out1) + bld_strides(out2)
        + [bias1.stride(0), bias2.stride(0)])
    rc = build.library().k3m_biattention_fwd(
        q1.data_ptr(), k1.data_ptr(), v1.data_ptr(), bias1.data_ptr(),
        q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), bias2.data_ptr(),
        out1.data_ptr(), out2.data_ptr(), _ptr(lse1), _ptr(lse2), _ptr(words1),
        _ptr(words2), build.DTYPE_CODES[q1.dtype],
        B, H, L1, L2, D, strides, 1.0 / math.sqrt(D), seed & U32,
        min1, scale1, min2, scale2, row0, head0,
        H if heads_global is None else heads_global, build.stream_handle(q1.device))
    build.check(rc, "k3m_biattention_fwd")
    fused_biattention.launches += 1
    return out1, out2, (lse1, words1), (lse2, words2)


class _FusedBiAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q1, k1, v1, bias1, q2, k2, v2, bias2, dropout1, dropout2, seed, row0,
                head0, heads_global):
        out1, out2, kept1, kept2 = _forward(q1, k1, v1, bias1, q2, k2, v2, bias2,
                                            dropout1, dropout2, seed, for_backward=True,
                                            row0=row0, head0=head0,
                                            heads_global=heads_global)
        ctx.save_for_backward(q1, k1, v1, bias1, q2, k2, v2, bias2, out1, out2, *kept1, *kept2)
        ctx.rates = (dropout1, dropout2)
        return out1, out2

    @staticmethod
    def backward(ctx, dctx1, dctx2):
        (q1, k1, v1, bias1, q2, k2, v2, bias2, out1, out2, lse1, words1, lse2,
         words2) = ctx.saved_tensors
        r1, r2 = ctx.rates
        dq2, dk1, dv1 = attention_bwd(q2, k1, v1, bias1, out1, lse1, words1, dctx1, r1)
        dq1, dk2, dv2 = attention_bwd(q1, k2, v2, bias2, out2, lse2, words2, dctx2, r2)
        return dq1, dk1, dv1, None, dq2, dk2, dv2, None, None, None, None, None, None, None


def fused_biattention(q1, k1, v1, bias1, q2, k2, v2, bias2, *,
                      dropout1: float = 0.0, dropout2: float = 0.0, seed: int = 0,
                      row0: int = 0, head0: int = 0, heads_global=None):
    """(ctx1, ctx2) as above; differentiable in the six projections."""
    keep_threshold(dropout1)
    keep_threshold(dropout2)
    B, _, H, _ = q1.shape
    heads_global = H if heads_global is None else heads_global
    check_mask_key("fused_biattention", B, H, row0, head0, heads_global)
    args = (q1, k1, v1, bias1, q2, k2, v2, bias2)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q1, k1, v1, q2, k2, v2)):
        return _FusedBiAttention.apply(*args, dropout1, dropout2, seed, row0, head0,
                                       heads_global)
    return _forward(*args, dropout1, dropout2, seed, row0=row0, head0=head0,
                    heads_global=heads_global)[:2]


fused_biattention.launches = 0
