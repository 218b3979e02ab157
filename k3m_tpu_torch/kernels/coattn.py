"""Fused bi-directional co-attention forward: CUDA kernel and plain version.

Stream 1 gives (q1, k1, v1, bias1) [B, L1, H, D], stream 2 gives
(q2, k2, v2, bias2) [B, L2, H, D]; the result is, in the order of
k3m_tpu/kernels/coattn.py:_biattn_kernel,
  ctx1 = softmax(q2 k1^T / sqrt(D) + bias1) v1   [B, L2, H, D]
  ctx2 = softmax(q1 k2^T / sqrt(D) + bias2) v2   [B, L1, H, D]
Each bias belongs to the KEY side of its direction.
"""

from __future__ import annotations

import math

import torch

from k3m_tpu_torch.kernels import build
from k3m_tpu_torch.kernels.attention import attention_plain, bld_strides, check_operands


def biattention_plain(q1, k1, v1, bias1, q2, k2, v2, bias2):
    return (attention_plain(q2, k1, v1, bias1),
            attention_plain(q1, k2, v2, bias2))


def fused_biattention(q1, k1, v1, bias1, q2, k2, v2, bias2, *,
                      dropout1: float = 0.0, dropout2: float = 0.0):
    if dropout1 > 0.0 or dropout2 > 0.0:
        raise NotImplementedError("co-attention dropout is not ported yet")
    if q1.device.type == "cpu":
        return biattention_plain(q1, k1, v1, bias1, q2, k2, v2, bias2)
    if q1.device.type != "cuda":
        raise ValueError(f"fused_biattention: unsupported device {q1.device}")
    check_operands(q2, k1, v1, bias1, "fused_biattention (direction 1)")
    check_operands(q1, k2, v2, bias2, "fused_biattention (direction 2)")
    B, L1, H, D = q1.shape
    L2 = q2.shape[1]
    if q1.dtype != q2.dtype or q1.device != q2.device or k1.shape[1] != L1:
        raise ValueError("fused_biattention: streams differ in dtype, device or length")
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
        B, H, L1, L2, D, strides, 1.0 / math.sqrt(D),
        build.stream_handle(q1.device))
    build.check(rc, "k3m_biattention_fwd")
    fused_biattention.launches += 1
    return out1, out2


fused_biattention.launches = 0
