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
(seed + salt, (row0 + b) * heads_global + head0 + h), word k % 4, has
`(bits >> 8) * 2^-24 >= rate`, and scales the kept ones by 1 / (1 - rate),
as `_dropout_mask` does with the TPU's own bits (which nothing here can
reproduce). `row0` (default 0) is the global row of the call's first row
under data parallelism, so that a rank's rows draw the mask of the same
rows of the global batch; `head0` (default 0) and `heads_global` (default
H) place the call's H heads among the layer's under tensor parallelism, so
that a model rank's heads draw the mask of the same heads. The kernels
(csrc/philox.cuh) and `philox_keep_mask_plain` compute the same bits.
Only the forward draws the mask: where a gradient is needed it keeps it,
one bit per element (`keep_words`, int32 [B, H, Lq, ceil(Lk / 32)], bit
k % 32 of word k // 32; the kernels on the card, `pack_keep_words` of the
plain mask on the CPU), and the backward reads those words on both devices.

The backward recomputes the probabilities: dV = P~^T dO,
dP = (dO V^T) keep / (1 - rate), dS = P (dP - rowsum(dP P)),
dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), no gradient for the bias
(attention.py:_attn_bwd_kernel). The kernel also takes the forward
kernel's fp32 row log-sum-exp `lse` [B, H, Lq] of the scaled, biased
scores, so that P = exp(S - lse) needs no pass of its own, and the output
O, whose rowsum(dO O) stands in for rowsum(dP P) inside the one pass over
the keys until the exact sum is known at its end (csrc/attention_bwd.cu).
The plain backward keeps the JAX formulas and reads only the mask.

Scale and widths. The scale is 1 / sqrt(D) unless the caller gives one
(`scale`): DeepSeek-V2's latent attention (model/deepseek.py) passes
m^2 / sqrt(192), YaRN's attention factor folded into the softmax scale.
q and k share their width D; v, and so the output, may be narrower: the
latent-attention instance takes q.k 192 wide and v 128 (SPLIT_DIMS), a
kernel of its own beside the one-width instances (bf16 on the card; the
plain version on the CPU, as for every instance).
"""

from __future__ import annotations

import math

import torch

from k3m_tpu_torch.kernels import build
from k3m_tpu_torch.utils import trace

HEAD_DIMS = (64, 96, 128)
SPLIT_DIMS = ((192, 128),)   # (q.k width, v width) of the two-width instances
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

def softmax_scale(q, scale=None) -> float:
    """The caller's scale, else 1 / sqrt(D) of q's width."""
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


def _scores_probs(q, k, bias, scale=None):
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * softmax_scale(q, scale)
    return torch.softmax(s + bias.float()[:, None, None, :], dim=-1)


def attention_lse_plain(q, k, bias, scale=None):
    """fp32 [B, H, Lq] logsumexp over the keys of the scaled, biased scores:
    what the forward kernels write for the backward."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * softmax_scale(q, scale)
    return torch.logsumexp(s + bias.float()[:, None, None, :], dim=-1)


def _drop_factor(keep, rate):
    return None if keep is None else keep.float() / (1.0 - rate)


def attention_plain(q, k, v, bias, keep=None, rate: float = 0.0, scale=None):
    """softmax(q k^T scale + bias), times `keep` / (1 - rate) where a
    bool keep mask [B, H, Lq, Lk] is given, then times v."""
    p = _scores_probs(q, k, bias, scale)
    f = _drop_factor(keep, rate)
    if f is not None:
        p = p * f
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def attention_bwd_plain(q, k, v, bias, dout, keep=None, rate: float = 0.0, scale=None):
    """(dq, dk, dv) in q's dtype, with the formulas of the backward kernel
    (rowsum(dP * P) from the recomputed P, as the TPU kernel takes it)."""
    scale = softmax_scale(q, scale)
    p = _scores_probs(q, k, bias, scale)
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
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[2:] != (H, D) \
            or v.shape[2] != H:
        raise ValueError(f"{name}: shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not match")
    dv = v.shape[-1]
    if dv != D:
        if (D, dv) not in SPLIT_DIMS:
            raise ValueError(f"{name}: head dims q.k {D} / v {dv} not in {SPLIT_DIMS}")
        if q.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the q.k {D} / v {dv} kernel is bf16 only")
    elif D not in HEAD_DIMS:
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


def keep_words_shape(q, lk, rate):
    """Shape of the mask words a forward under dropout keeps for its
    backward, else None."""
    if rate <= 0.0:
        return None
    B, Lq, H, _ = q.shape
    return (B, H, Lq, -(-lk // 32))


def keep_words_for(q, lk, rate):
    """Uninitialized mask words for a forward (keep_words_shape), or None."""
    shape = keep_words_shape(q, lk, rate)
    return None if shape is None else torch.empty(shape, dtype=torch.int32, device=q.device)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _plain_forward(q, k, v, bias, rate, seed, salt, for_backward, row0=0, head0=0,
                   heads_global=None, scale=None):
    """(out, None, keep_words) of one direction on the CPU: the plain
    version, and where a backward follows under dropout the words of its
    mask (the plain backward reads no lse)."""
    keep = _plain_keep(q, k, rate, seed, salt, row0, head0, heads_global)
    words = pack_keep_words(keep) if for_backward and keep is not None else None
    return attention_plain(q, k, v, bias, keep, rate, scale), None, words


@trace.spanned("k3m.kernel.fused_attention", arguments=True)
def _forward(q, k, v, bias, rate, seed, for_backward=False, row0=0, head0=0,
             heads_global=None, scale=None):
    """(out, lse, keep_words): the kernel for CUDA tensors, which keeps lse
    and (under dropout) the mask words where the backward will read them;
    the plain version for CPU tensors, which keeps the mask words alone."""
    if _device_kind(q, "fused_attention") == "cpu":
        return _plain_forward(q, k, v, bias, rate, seed, 0, for_backward, row0, head0,
                              heads_global, scale)
    check_operands(q, k, v, bias, "fused_attention")
    keep_min, keep_scale = keep_threshold(rate)
    B, Lq, H, D = q.shape
    dv = v.shape[-1]
    out = torch.empty((B, Lq, H, dv), dtype=q.dtype, device=q.device)
    lse = words = None
    if for_backward:
        lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
        words = keep_words_for(q, k.shape[1], rate)
    strides = build.int64_array(bld_strides(q) + bld_strides(k) + bld_strides(v)
                                + bld_strides(out) + [bias.stride(0)])
    tail = (strides, softmax_scale(q, scale), seed & U32, keep_min, keep_scale, row0, head0,
            H if heads_global is None else heads_global, build.stream_handle(q.device))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            _ptr(lse), _ptr(words))
    lib = build.library()
    if dv == D:
        rc = lib.k3m_attention_fwd(*ptrs, build.DTYPE_CODES[q.dtype], B, H, Lq, k.shape[1],
                                   D, *tail)
    else:
        rc = lib.k3m_attention_fwd_split(*ptrs, B, H, Lq, k.shape[1], D, dv, *tail)
    build.check(rc, "k3m_attention_fwd")
    fused_attention.launches += 1
    return out, lse, words


@trace.spanned("k3m.kernel.attention_bwd", arguments=True)
def attention_bwd(q, k, v, bias, out, lse, keep_words, dout, rate: float = 0.0, scale=None):
    """(dq, dk, dv) of one attention direction whose forward at `rate` gave
    `out`, the row log-sum-exp `lse` and, under dropout, its mask words
    `keep_words` (`_forward(..., for_backward=True)`): the backward kernel
    for CUDA tensors, the plain version for CPU tensors, which reads only
    the mask words."""
    device = _device_kind(q, "attention_bwd")
    keep_min, keep_scale = keep_threshold(rate)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    want = keep_words_shape(q, Lk, rate)
    if want is not None and (keep_words is None or keep_words.shape != want
                             or keep_words.dtype != torch.int32
                             or not keep_words.is_contiguous()
                             or keep_words.device != q.device):
        raise ValueError(f"attention_bwd: dropout needs the forward's keep_words int32 {want}")
    if device == "cpu":
        keep = None if want is None else unpack_keep_words(keep_words, Lk)
        return attention_bwd_plain(q, k, v, bias, dout, keep, rate, scale)
    if not _rows_aligned(dout):
        dout = dout.contiguous()
    check_operands(q, k, v, bias, "attention_bwd")
    dv_width = v.shape[-1]
    for name, t in (("dout", dout), ("out", out)):
        if t.shape != (B, Lq, H, dv_width) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"attention_bwd: {name} must be q's rows at v's width, "
                             "in q's dtype")
    if q.dtype == torch.bfloat16 and not _rows_aligned(out):
        raise ValueError("attention_bwd: bf16 out rows must be 16-byte aligned")
    if lse.dtype != torch.float32 or lse.shape != (B, H, Lq) or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"attention_bwd: lse must be contiguous fp32 [{B}, {H}, {Lq}]")
    dq = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Lk, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Lk, H, dv_width), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    strides = build.int64_array(bld_strides(q) + bld_strides(k) + bld_strides(v)
                                + bld_strides(out) + bld_strides(dout) + [bias.stride(0)])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _ptr(keep_words if want is not None else None), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr())
    tail = (strides, softmax_scale(q, scale), keep_min, keep_scale,
            build.stream_handle(q.device))
    lib = build.library()
    if dv_width == D:
        rc = lib.k3m_attention_bwd(*ptrs, build.DTYPE_CODES[q.dtype], B, H, Lq, Lk, D, *tail)
    else:
        rc = lib.k3m_attention_bwd_split(*ptrs, B, H, Lq, Lk, D, dv_width, *tail)
    build.check(rc, "k3m_attention_bwd")
    attention_bwd.launches += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, rate, seed, row0, head0, heads_global, scale):
        out, lse, words = _forward(q, k, v, bias, rate, seed, for_backward=True,
                                   row0=row0, head0=head0, heads_global=heads_global,
                                   scale=scale)
        ctx.save_for_backward(q, k, v, bias, out, lse, words)
        ctx.rate = rate
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = attention_bwd(*ctx.saved_tensors, dout, ctx.rate, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None, None, None, None


def check_mask_key(name, B, H, row0, head0, heads_global):
    """Raise where the Philox key words of rows row0 .. row0 + B - 1 and
    heads head0 .. head0 + H - 1 of `heads_global` are not all distinct
    and below 2^31 (the same check on the CPU and on the card)."""
    if row0 < 0:
        raise ValueError(f"{name}: row0 {row0} < 0")
    if head0 < 0:
        raise ValueError(f"{name}: head0 {head0} < 0")
    if heads_global < head0 + H:
        raise ValueError(f"{name}: heads {head0}..{head0 + H - 1} beyond heads_global "
                         f"{heads_global}")
    if (row0 + B) * heads_global > 2 ** 31 - 1:
        raise ValueError(f"{name}: the mask key (row0 + B) * heads_global = "
                         f"{(row0 + B) * heads_global} is beyond 2^31")


def fused_attention(q, k, v, bias, *, dropout_rate: float = 0.0, seed: int = 0,
                    row0: int = 0, head0: int = 0, heads_global=None, scale=None):
    """softmax(q k^T scale + bias) v per (batch, head), scale 1 / sqrt(D)
    unless given, probabilities
    dropped at `dropout_rate` with the Philox mask of `seed` for rows
    row0 .. row0 + B - 1 and heads head0 .. head0 + H - 1 of `heads_global`
    (default H). Differentiable in q, k and v."""
    keep_threshold(dropout_rate)
    B, _, H, _ = q.shape
    heads_global = H if heads_global is None else heads_global
    check_mask_key("fused_attention", B, H, row0, head0, heads_global)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FusedAttention.apply(q, k, v, bias, dropout_rate, seed, row0, head0,
                                     heads_global, scale)
    return _forward(q, k, v, bias, dropout_rate, seed, row0=row0, head0=head0,
                    heads_global=heads_global, scale=scale)[0]


fused_attention.launches = 0
attention_bwd.launches = 0
