"""Attention with dropout on the probabilities, plain PyTorch only: the
Philox4x32-10 keep mask, its words, and the softmax forward and backward,
on whatever device the tensors are (a frozen copy of the port's plain
versions). `fused_attention` keeps the port's signature and runs the
plain forward, its backward the plain backward."""

from __future__ import annotations

import math

import torch


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
                           rate: float, salt: int = 0, device="cpu", row0: int = 0,
                           head0: int = 0, heads_global=None):
    """The kernels' dropout keep mask, bool [B, H, Lq, Lk], of rows
    row0 .. row0 + B - 1 and heads head0 .. head0 + H - 1 of `heads_global`
    (default H)."""
    keep_min, _ = keep_threshold(rate)
    hg = H if heads_global is None else heads_global
    lk4 = -(-Lk // 4)
    rows = torch.arange(row0, row0 + B, dtype=torch.int64, device=device)
    heads = torch.arange(head0, head0 + H, dtype=torch.int64, device=device)
    bh = (rows[:, None] * hg + heads[None, :]).reshape(-1)[:, None, None]
    q = torch.arange(Lq, dtype=torch.int64, device=device)[None, :, None]
    kb = torch.arange(lk4, dtype=torch.int64, device=device)[None, None, :]
    shape = (B * H, Lq, lk4)
    words = philox4x32_10_plain(
        (kb.expand(shape), q.expand(shape), 0, 0),
        ((seed + salt) & U32, bh.expand(shape)))
    bits = torch.stack(words, dim=-1).reshape(B, H, Lq, lk4 * 4)[..., :Lk]
    return (bits >> 8) >= keep_min


def pack_keep_words(keep):
    """int32 [..., ceil(Lk / 32)] words of a bool keep mask [..., Lk], bit
    k % 32 of word k // 32 keeping key k (zero past Lk), as the forward
    kernels store them."""
    lk = keep.shape[-1]
    n = -(-lk // 32)
    bits = torch.nn.functional.pad(keep.to(torch.int64), (0, 32 * n - lk))
    shifts = torch.arange(32, dtype=torch.int64, device=keep.device)
    w = (bits.reshape(*keep.shape[:-1], n, 32) << shifts).sum(-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def unpack_keep_words(words, lk: int):
    """The bool keep mask [..., lk] of mask words (pack_keep_words)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.bool().reshape(*words.shape[:-1], -1)[..., :lk]


# ------------------------------------------------------------------ plain

def _scores_probs(q, k, bias):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.softmax(s + bias.float()[:, None, None, :], dim=-1)


def attention_lse_plain(q, k, bias):
    """fp32 [B, H, Lq] logsumexp over the keys of the scaled, biased scores:
    what the forward kernels write for the backward."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.logsumexp(s + bias.float()[:, None, None, :], dim=-1)


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


def _plain_keep(q, k, rate, seed, salt, row0=0, head0=0, heads_global=None):
    if rate <= 0.0:
        return None
    B, Lq, H, _ = q.shape
    return philox_keep_mask_plain(seed, B, H, Lq, k.shape[1], rate, salt, q.device, row0,
                                  head0, heads_global)


def plain_forward(q, k, v, bias, rate, seed, salt, for_backward, row0=0, head0=0,
                  heads_global=None):
    """(out, keep_words or None) of one direction: the plain version, and
    where a backward follows under dropout the words of its mask."""
    keep = _plain_keep(q, k, rate, seed, salt, row0, head0, heads_global)
    words = pack_keep_words(keep) if for_backward and keep is not None else None
    return attention_plain(q, k, v, bias, keep, rate), words


def plain_backward(q, k, v, bias, words, dout, rate):
    keep = None if words is None else unpack_keep_words(words, k.shape[1])
    return attention_bwd_plain(q, k, v, bias, dout, keep, rate)


class _PlainAttention(torch.autograd.Function):
    """Saves q, k, v, bias and the mask words, never the probabilities."""

    @staticmethod
    def forward(ctx, q, k, v, bias, rate, seed, row0, head0, heads_global):
        out, words = plain_forward(q, k, v, bias, rate, seed, 0, True, row0, head0,
                                   heads_global)
        ctx.save_for_backward(q, k, v, bias, words)
        ctx.rate = rate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, words = ctx.saved_tensors
        dq, dk, dv = plain_backward(q, k, v, bias, words, dout, ctx.rate)
        return dq, dk, dv, None, None, None, None, None, None


def fused_attention(q, k, v, bias, *, dropout_rate: float = 0.0, seed: int = 0,
                    row0: int = 0, head0: int = 0, heads_global=None):
    """softmax(q k^T / sqrt(D) + bias) v per (batch, head), probabilities
    dropped at `dropout_rate` with the Philox mask of `seed`."""
    keep_threshold(dropout_rate)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _PlainAttention.apply(q, k, v, bias, dropout_rate, seed, row0, head0,
                                     heads_global)
    return plain_forward(q, k, v, bias, dropout_rate, seed, 0, False, row0, head0,
                         heads_global)[0]
