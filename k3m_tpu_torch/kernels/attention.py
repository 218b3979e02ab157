"""Fused self-attention, forward and backward, with dropout on the
probabilities: CUDA kernels and plain versions.

Layout is the model's: q [B, Lq, H, D], k/v [B, Lk, H, D] (any strides
over B, L and H, unit stride over D; in bf16, forward and backward,
16-byte aligned rows), bias [B, Lk] additive fp32 key bias (-10000 on masked keys). The
output is a contiguous [B, Lq, H, D] in q's dtype. Numerics follow
k3m_tpu/kernels/attention.py: fp32 scores, fp32 softmax, fp32 accumulation,
one cast at the end; the bf16 forward kernel rounds the probabilities to
bf16 once, for the tensor-core P V product.

Dropout (rate > 0) keeps probability (q, k) of head (b, h) where the
Philox4x32-10 word of counter (k // 4, q, 0, 0) under key
(seed + salt, b * H + h), word k % 4, has `(bits >> 8) * 2^-24 >= rate`,
and scales the kept ones by 1 / (1 - rate), as `_dropout_mask` does with
the TPU's own bits (which nothing here can reproduce). The kernels
(csrc/philox.cuh) and `philox_keep_mask_plain` compute the same bits, so
the forward, the backward and the plain versions share one mask.

The backward recomputes the probabilities and the mask (nothing
[Lq, Lk]-shaped is saved): dV = P~^T dO, dP = (dO V^T) keep / (1 - rate),
dS = P (dP - rowsum(dP P)), dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), no
gradient for the bias (attention.py:_attn_bwd_kernel).
"""

from __future__ import annotations

import math

import torch

from k3m_tpu_torch.kernels import build

HEAD_DIMS = (64, 96, 128)
U32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


# ------------------------------------------------------------------ Philox

def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a * b for a < 2^32 and int64 b in [0, 2^32),
    without leaving int64: b is split into 16-bit halves."""
    t1 = a * (b & 0xFFFF)                   # < 2^48
    t2 = a * (b >> 16)                      # < 2^48
    s = ((t2 & 0xFFFF) << 16) + t1          # < 2^49
    return (t2 >> 16) + (s >> 32), s & U32


def philox4x32_10_plain(ctr, key):
    """Philox4x32-10 (Salmon et al., SC'11; the Random123 definition) in
    torch int64 arithmetic. `ctr`: four int64 tensors (or ints) of 32-bit
    words, `key`: two; returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & U32
        k1 = (k1 + _PHILOX_W[1]) & U32
    return c0, c1, c2, c3


def keep_threshold(rate: float):
    """(keep_min, keep_scale): keep iff (bits >> 8) >= keep_min, which is
    `(bits >> 8) * 2^-24 >= rate` in integers (rate compared in fp32, as
    the TPU kernel compares it); kept values scaled by keep_scale."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} not in [0, 1)")
    if rate == 0.0:
        return 0, 1.0
    r32 = torch.tensor(rate, dtype=torch.float32).item()
    return math.ceil(r32 * 2 ** 24), 1.0 / (1.0 - rate)


def philox_keep_mask_plain(seed: int, B: int, H: int, Lq: int, Lk: int,
                           rate: float, salt: int = 0, device="cpu"):
    """The kernels' dropout keep mask, bool [B, H, Lq, Lk]."""
    keep_min, _ = keep_threshold(rate)
    lk4 = -(-Lk // 4)
    bh = torch.arange(B * H, dtype=torch.int64, device=device)[:, None, None]
    q = torch.arange(Lq, dtype=torch.int64, device=device)[None, :, None]
    kb = torch.arange(lk4, dtype=torch.int64, device=device)[None, None, :]
    shape = (B * H, Lq, lk4)
    words = philox4x32_10_plain(
        (kb.expand(shape), q.expand(shape), 0, 0),
        ((seed + salt) & U32, bh.expand(shape)))
    bits = torch.stack(words, dim=-1).reshape(B, H, Lq, lk4 * 4)[..., :Lk]
    return (bits >> 8) >= keep_min


# ------------------------------------------------------------------ plain

def _scores_probs(q, k, bias):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.softmax(s + bias.float()[:, None, None, :], dim=-1)


def _drop_factor(keep, rate):
    return None if keep is None else keep.float() / (1.0 - rate)


def attention_plain(q, k, v, bias, keep=None, rate: float = 0.0):
    """softmax(q k^T / sqrt(D) + bias), times `keep` / (1 - rate) where a
    bool keep mask [B, H, Lq, Lk] is given, then times v."""
    p = _scores_probs(q, k, bias)
    f = _drop_factor(keep, rate)
    if f is not None:
        p = p * f
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def attention_bwd_plain(q, k, v, bias, dout, keep=None, rate: float = 0.0):
    """(dq, dk, dv) in q's dtype, with the formulas of the backward kernel
    (rowsum(dP * P) from the recomputed P, as the TPU kernel takes it)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _scores_probs(q, k, bias)
    f = _drop_factor(keep, rate)
    do = dout.float()
    pd = p if f is None else p * f
    dv = torch.einsum("bhqk,bqhd->bkhd", pd, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    if f is not None:
        dp = dp * f
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _plain_keep(q, k, rate, seed, salt):
    if rate <= 0.0:
        return None
    B, Lq, H, _ = q.shape
    return philox_keep_mask_plain(seed, B, H, Lq, k.shape[1], rate, salt, q.device)


# ------------------------------------------------------------------ kernels

def _rows_aligned(t):
    """Unit stride over D and every row starting 16-byte aligned, as the
    bf16 tensor-core tiles read them."""
    return t.stride(-1) == 1 and not (t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]))


def check_operands(q, k, v, bias, name):
    """Validate one direction's operands for the CUDA kernels: bf16 rows
    must start 16-byte aligned (the tensor-core tiles, forward and
    backward)."""
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
    if q.dtype == torch.bfloat16 and not all(_rows_aligned(t) for t in (q, k, v)):
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


def _device_kind(t, name):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type


def _forward(q, k, v, bias, rate, seed):
    if _device_kind(q, "fused_attention") == "cpu":
        return attention_plain(q, k, v, bias, _plain_keep(q, k, rate, seed, 0), rate)
    check_operands(q, k, v, bias, "fused_attention")
    keep_min, keep_scale = keep_threshold(rate)
    B, Lq, H, D = q.shape
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    strides = build.int64_array(bld_strides(q) + bld_strides(k) + bld_strides(v)
                                + bld_strides(out) + [bias.stride(0)])
    rc = build.library().k3m_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), build.DTYPE_CODES[q.dtype], B, H, Lq, k.shape[1], D, strides,
        1.0 / math.sqrt(D), seed & U32, keep_min, keep_scale,
        build.stream_handle(q.device))
    build.check(rc, "k3m_attention_fwd")
    fused_attention.launches += 1
    return out


def attention_bwd(q, k, v, bias, dout, rate: float = 0.0, seed: int = 0,
                  salt: int = 0):
    """(dq, dk, dv) of one attention direction whose forward drew its mask
    from (seed, salt): the backward kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if _device_kind(q, "attention_bwd") == "cpu":
        return attention_bwd_plain(q, k, v, bias, dout,
                                   _plain_keep(q, k, rate, seed, salt), rate)
    if not _rows_aligned(dout):
        dout = dout.contiguous()
    check_operands(q, k, v, bias, "attention_bwd")
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("attention_bwd: dout must be shaped and typed like q")
    keep_min, keep_scale = keep_threshold(rate)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    dq = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Lk, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Lk, H, D), dtype=q.dtype, device=q.device)
    stats = torch.empty((2, B, H, Lq), dtype=torch.float32, device=q.device)
    strides = build.int64_array(bld_strides(q) + bld_strides(k) + bld_strides(v)
                                + bld_strides(dout) + [bias.stride(0)])
    rc = build.library().k3m_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(),
        stats[1].data_ptr(), build.DTYPE_CODES[q.dtype], B, H, Lq, Lk, D, strides,
        1.0 / math.sqrt(D), (seed + salt) & U32, keep_min, keep_scale,
        build.stream_handle(q.device))
    build.check(rc, "k3m_attention_bwd")
    attention_bwd.launches += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, rate, seed):
        ctx.save_for_backward(q, k, v, bias)
        ctx.rate, ctx.seed = rate, seed
        return _forward(q, k, v, bias, rate, seed)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, bias, dout, ctx.rate, ctx.seed)
        return dq, dk, dv, None, None, None


def fused_attention(q, k, v, bias, *, dropout_rate: float = 0.0, seed: int = 0):
    """softmax(q k^T / sqrt(D) + bias) v per (batch, head), probabilities
    dropped at `dropout_rate` with the Philox mask of `seed`.
    Differentiable in q, k and v."""
    keep_threshold(dropout_rate)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FusedAttention.apply(q, k, v, bias, dropout_rate, seed)
    return _forward(q, k, v, bias, dropout_rate, seed)


fused_attention.launches = 0
attention_bwd.launches = 0
