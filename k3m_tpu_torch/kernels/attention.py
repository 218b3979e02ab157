"""Fused self-attention forward: CUDA kernel and plain version.

Layout is the model's: q [B, Lq, H, D], k/v [B, Lk, H, D] (any strides
over B, L and H, unit stride over D; in bf16 16-byte aligned rows), bias
[B, Lk] additive fp32 key bias (-10000 on masked keys). The output is a
contiguous [B, Lq, H, D] in q's dtype. Numerics follow
k3m_tpu/kernels/attention.py:_attn_kernel: fp32 scores, fp32 softmax, fp32
accumulation, one cast at the end; the bf16 kernel rounds the
probabilities to bf16 once, for the tensor-core P V product.
"""

from __future__ import annotations

import math

import torch

from k3m_tpu_torch.kernels import build

HEAD_DIMS = (64, 96, 128)


def attention_plain(q, k, v, bias):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s + bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def check_operands(q, k, v, bias, name):
    """Validate one direction's operands for the CUDA kernels."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q/k/v must be [B, L, H, D]")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (H, D):
        raise ValueError(f"{name}: shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not match")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share a dtype in fp32/bf16")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim must have unit stride")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]) for t in (q, k, v)):
        raise ValueError(f"{name}: bf16 q/k/v rows must be 16-byte aligned "
                         "(strides multiples of 8 elements)")
    if bias.dtype != torch.float32 or bias.shape != (B, k.shape[1]) \
            or bias.stride(-1) != 1:
        raise ValueError(f"{name}: bias must be fp32 [B, Lk] with unit stride")
    if any(t.device != q.device for t in (k, v, bias)):
        raise ValueError(f"{name}: operands on different devices")


def bld_strides(t):
    """(batch, seq, head) strides of a [B, L, H, D] tensor, in elements."""
    return [t.stride(0), t.stride(1), t.stride(2)]


def fused_attention(q, k, v, bias, *, dropout_rate: float = 0.0):
    """softmax(q k^T / sqrt(D) + bias) v per (batch, head)."""
    if dropout_rate > 0.0:
        raise NotImplementedError("attention dropout is not ported yet")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    check_operands(q, k, v, bias, "fused_attention")
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    strides = build.int64_array(bld_strides(q) + bld_strides(k) + bld_strides(v)
                                + bld_strides(out) + [bias.stride(0)])
    rc = build.library().k3m_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), build.DTYPE_CODES[q.dtype], B, H, Lq, Lk, D, strides,
        1.0 / math.sqrt(D), build.stream_handle(q.device))
    build.check(rc, "k3m_attention_fwd")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
