"""Bi-directional co-attention, plain PyTorch only (a frozen copy of the
port's plain version): ctx1 = softmax(q2 k1^T / sqrt(D) + bias1) v1,
ctx2 = softmax(q1 k2^T / sqrt(D) + bias2) v2; direction 1 draws its
Philox mask from `seed`, direction 2 from `seed + 7919`."""

from __future__ import annotations

import torch

from .attention import keep_threshold, plain_backward, plain_forward

SALT2 = 7919


class _PlainBiAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q1, k1, v1, bias1, q2, k2, v2, bias2, dropout1, dropout2, seed, row0,
                head0, heads_global):
        out1, w1 = plain_forward(q2, k1, v1, bias1, dropout1, seed, 0, True, row0, head0,
                                 heads_global)
        out2, w2 = plain_forward(q1, k2, v2, bias2, dropout2, seed, SALT2, True, row0,
                                 head0, heads_global)
        ctx.save_for_backward(q1, k1, v1, bias1, q2, k2, v2, bias2, w1, w2)
        ctx.rates = (dropout1, dropout2)
        return out1, out2

    @staticmethod
    def backward(ctx, dctx1, dctx2):
        q1, k1, v1, bias1, q2, k2, v2, bias2, w1, w2 = ctx.saved_tensors
        r1, r2 = ctx.rates
        dq2, dk1, dv1 = plain_backward(q2, k1, v1, bias1, w1, dctx1, r1)
        dq1, dk2, dv2 = plain_backward(q1, k2, v2, bias2, w2, dctx2, r2)
        return dq1, dk1, dv1, None, dq2, dk2, dv2, None, None, None, None, None, None, None


def fused_biattention(q1, k1, v1, bias1, q2, k2, v2, bias2, *,
                      dropout1: float = 0.0, dropout2: float = 0.0, seed: int = 0,
                      row0: int = 0, head0: int = 0, heads_global=None):
    keep_threshold(dropout1)
    keep_threshold(dropout2)
    args = (q1, k1, v1, bias1, q2, k2, v2, bias2)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q1, k1, v1, q2, k2, v2)):
        return _PlainBiAttention.apply(*args, dropout1, dropout2, seed, row0, head0,
                                       heads_global)
    out1, _ = plain_forward(q2, k1, v1, bias1, dropout1, seed, 0, False, row0, head0,
                            heads_global)
    out2, _ = plain_forward(q1, k2, v2, bias2, dropout2, seed, SALT2, False, row0, head0,
                            heads_global)
    return out1, out2
