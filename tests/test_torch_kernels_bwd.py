"""The port's backward kernels' plain versions and its attention dropout,
against the JAX package's Pallas VJPs in interpret mode and against numpy.

On the CPU each differentiable wrapper runs its plain forward and, in the
backward, `layernorm_bwd_plain` / `attention_bwd_plain`: the formulas the
CUDA kernels implement. They are held here to `jax.grad` of the Pallas
kernels (fp32, rate 0: interpret mode has no TPU PRNG), with the
tolerances of tests/test_kernels.py (5e-4 for LayerNorm, whose backward
rebuilds xhat from the saved output; 2e-4 for attention). At rate 0.1 the
plain forward and backward with an explicit mask are held to a float64
numpy composition of the same formulas (1e-5). The CUDA kernels are held to
the plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k3m_tpu.kernels.attention import padded_fused_attention
from k3m_tpu.kernels.coattn import padded_fused_biattention
from k3m_tpu.kernels.layernorm import fused_layernorm as jax_layernorm
from k3m_tpu_torch.kernels import (
    attention_bwd, attention_bwd_plain, attention_lse_plain, attention_plain,
    fused_attention, fused_biattention, fused_layernorm, philox_keep_mask_plain,
)
from k3m_tpu_torch.kernels import attention
from k3m_tpu_torch.kernels.attention import keep_threshold, philox4x32_10_plain


def _bld(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))


def _bhld(t):
    return t.detach().numpy().transpose(0, 2, 1, 3)


def _attn_inputs(rng, B, H, Lq, Lk, D):
    q = rng.normal(size=(B, H, Lq, D)).astype(np.float32)
    k = rng.normal(size=(B, H, Lk, D)).astype(np.float32)
    v = rng.normal(size=(B, H, Lk, D)).astype(np.float32)
    mask = np.ones((B, Lk), np.float32)
    for b in range(1, B):
        mask[b, Lk - (2 + b):] = 0
    return q, k, v, ((1 - mask) * -10000.0).astype(np.float32)


# ------------------------------------------------------------- LayerNorm

@pytest.mark.parametrize("shape,with_res", [((3, 33, 768), True), ((2, 37, 1024), False),
                                            ((4, 9, 96), True)])
def test_layernorm_grads_match_pallas(shape, with_res):
    rng = np.random.default_rng(6)
    x = rng.standard_normal(shape).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32) if with_res else None
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    scale[0] = 3e-7          # the 1e-6 guard of the xhat reconstruction
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)

    def loss(x, res, scale, bias):
        return (jax_layernorm(x, scale, bias, res, interpret=True) * w).sum()

    args = [jnp.asarray(a) if a is not None else None for a in (x, res, scale, bias)]
    argnums = (0, 1, 2, 3) if with_res else (0, 2, 3)
    want = jax.grad(loss, argnums=argnums)(*args)
    ts = [torch.from_numpy(a).requires_grad_() if a is not None else None
          for a in (x, res, scale, bias)]
    out = fused_layernorm(ts[0], ts[2], ts[3], ts[1])
    got = torch.autograd.grad(out, [t for t in ts if t is not None], torch.from_numpy(w))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-4, atol=5e-4)


def test_layernorm_bf16_grads_keep_input_dtypes():
    """dx comes back in x's dtype and dres in the residual's (the image
    embedding LN: bf16 input and residual; the text embedding LN: fp32
    input, bf16 output)."""
    x = torch.randn(4, 24).requires_grad_()
    r = torch.randn(4, 24, dtype=torch.bfloat16).requires_grad_()
    s, b = torch.ones(24, requires_grad=True), torch.zeros(24, requires_grad=True)
    out = fused_layernorm(x, s, b, r, out_dtype=torch.bfloat16)
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16 and x.grad.dtype == torch.float32
    assert r.grad.dtype == torch.bfloat16 and s.grad.dtype == torch.float32


# ------------------------------------------------------------- attention

@pytest.mark.parametrize("B,H,Lq,Lk,D", [(2, 3, 16, 24, 8), (2, 2, 13, 37, 64),
                                         (2, 2, 37, 37, 128), (2, 2, 19, 11, 96)])
def test_attention_grads_match_pallas(B, H, Lq, Lk, D):
    rng = np.random.default_rng(B * Lq + D)
    q, k, v, bias = _attn_inputs(rng, B, H, Lq, Lk, D)
    w = rng.normal(size=(B, H, Lq, D)).astype(np.float32)

    def loss(q, k, v):
        out = padded_fused_attention(q, k, v, jnp.asarray(bias[:, None, None, :]),
                                     interpret=True)
        return (out * w).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = attention_bwd_plain(_bld(q), _bld(k), _bld(v), torch.from_numpy(bias), _bld(w))
    for g, r in zip(got, want):
        np.testing.assert_allclose(_bhld(g), np.asarray(r), rtol=2e-4, atol=2e-4)
    # the differentiable wrapper takes the same backward
    tq, tk, tv = (_bld(a).requires_grad_() for a in (q, k, v))
    out = fused_attention(tq, tk, tv, torch.from_numpy(bias))
    for g, r in zip(torch.autograd.grad(out, (tq, tk, tv), _bld(w)), got):
        torch.testing.assert_close(g, r)


@pytest.mark.parametrize("L1,L2,D", [(11, 19, 8), (37, 50, 128), (50, 13, 96)])
def test_biattention_grads_match_pallas(L1, L2, D):
    B, H = 2, 2
    rng = np.random.default_rng(L1 + L2)
    q1, k1, v1, b1 = _attn_inputs(rng, B, H, L1, L1, D)
    q2, k2, v2, b2 = _attn_inputs(rng, B, H, L2, L2, D)
    w1 = rng.normal(size=(B, H, L2, D)).astype(np.float32)
    w2 = rng.normal(size=(B, H, L1, D)).astype(np.float32)

    def loss(q1, k1, v1, q2, k2, v2):
        c1, c2 = padded_fused_biattention(
            q1, k1, v1, jnp.asarray(b1[:, None, None, :]), q2, k2, v2,
            jnp.asarray(b2[:, None, None, :]), interpret=True)
        return (c1 * w1).sum() + (c2 * w2).sum()

    arrays = (q1, k1, v1, q2, k2, v2)
    want = jax.grad(loss, argnums=tuple(range(6)))(*map(jnp.asarray, arrays))
    ts = [_bld(a).requires_grad_() for a in arrays]
    c1, c2 = fused_biattention(ts[0], ts[1], ts[2], torch.from_numpy(b1),
                               ts[3], ts[4], ts[5], torch.from_numpy(b2))
    got = torch.autograd.grad((c1, c2), ts, (_bld(w1), _bld(w2)))
    for g, r in zip(got, want):
        np.testing.assert_allclose(_bhld(g), np.asarray(r), rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------- dropout

def _numpy_attention(q, k, v, bias, keep, rate, w):
    """float64 forward and (dq, dk, dv) of softmax(qk^T/sqrt(D) + bias)
    * keep / (1 - rate) @ v against the cotangent w; [B, H, L, D] arrays."""
    q, k, v, w = (a.astype(np.float64) for a in (q, k, v, w))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1]) + bias[:, None, None, :]
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    f = keep / (1.0 - rate)
    out = np.einsum("bhqk,bhkd->bhqd", p * f, v)
    dv = np.einsum("bhqk,bhqd->bhkd", p * f, w)
    dp = np.einsum("bhqd,bhkd->bhqk", w, v) * f
    ds = p * (dp - (dp * p).sum(-1, keepdims=True))
    dq = np.einsum("bhqk,bhkd->bhqd", ds, k) / np.sqrt(q.shape[-1])
    dk = np.einsum("bhqk,bhqd->bhkd", ds, q) / np.sqrt(q.shape[-1])
    return out, (dq, dk, dv)


def test_dropout_plain_versions_match_numpy():
    B, H, Lq, Lk, D, rate = 2, 3, 9, 14, 16, 0.1
    rng = np.random.default_rng(11)
    q, k, v, bias = _attn_inputs(rng, B, H, Lq, Lk, D)
    keep = (rng.random((B, H, Lq, Lk)) >= rate)
    w = rng.normal(size=(B, H, Lq, D)).astype(np.float32)
    want_out, want_grads = _numpy_attention(q, k, v, bias, keep, rate, w)
    tk = torch.from_numpy(keep)
    out = attention_plain(_bld(q), _bld(k), _bld(v), torch.from_numpy(bias), tk, rate)
    np.testing.assert_allclose(_bhld(out), want_out, rtol=1e-5, atol=1e-5)
    got = attention_bwd_plain(_bld(q), _bld(k), _bld(v), torch.from_numpy(bias),
                              _bld(w), tk, rate)
    for g, r in zip(got, want_grads):
        np.testing.assert_allclose(_bhld(g), r, rtol=1e-5, atol=1e-5)


def test_dropout_wrappers_use_the_philox_mask():
    """On the CPU the wrappers draw their mask with philox_keep_mask_plain
    from (seed, salt): salt 0 for self-attention and co-attention direction
    1, 7919 for direction 2, and the backward reads the mask the forward
    kept."""
    B, H, L1, L2, D, rate, seed = 2, 2, 6, 10, 8, 0.3, 1234
    rng = np.random.default_rng(3)
    q1, k1, v1, b1 = (torch.from_numpy(a) for a in _attn_inputs(rng, B, H, L1, L1, D))
    q2, k2, v2, b2 = (torch.from_numpy(a) for a in _attn_inputs(rng, B, H, L2, L2, D))
    q1, k1, v1, q2, k2, v2 = (t.permute(0, 2, 1, 3).contiguous().requires_grad_()
                              for t in (q1, k1, v1, q2, k2, v2))
    m1 = philox_keep_mask_plain(seed, B, H, L2, L1, rate, 0)
    m2 = philox_keep_mask_plain(seed, B, H, L1, L2, rate, 7919)
    assert not torch.equal(m1[:, :, :L1, :L1], m2[:, :, :L1, :L1].transpose(2, 3))
    c1, c2 = fused_biattention(q1, k1, v1, b1, q2, k2, v2, b2, dropout1=rate,
                               dropout2=rate, seed=seed)
    torch.testing.assert_close(c1, attention_plain(q2, k1, v1, b1, m1, rate))
    torch.testing.assert_close(c2, attention_plain(q1, k2, v2, b2, m2, rate))
    w2 = torch.randn_like(c2)
    got = torch.autograd.grad(c2, (q1, k2, v2), w2)
    want = attention_bwd_plain(q1, k2, v2, b2, w2, m2, rate)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r)
    out = fused_attention(q2, k2, v2, b2, dropout_rate=rate, seed=seed)
    torch.testing.assert_close(out, attention_plain(
        q2, k2, v2, b2, philox_keep_mask_plain(seed, B, H, L2, L2, rate), rate))


# ------------------------------------------ the backward's inputs from the forward

@pytest.mark.parametrize("Lq,Lk,D", [(9, 14, 16), (5, 37, 64)])
def test_attention_lse_plain_matches_numpy(Lq, Lk, D):
    """attention_lse_plain: the fp32 log-sum-exp over the keys of the scaled,
    biased scores, against float64 numpy, with ragged key masks."""
    rng = np.random.default_rng(Lk)
    q, k, _, bias = _attn_inputs(rng, 3, 2, Lq, Lk, D)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64))
    s = s / np.sqrt(D) + bias[:, None, None, :]
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    got = attention_lse_plain(_bld(q), _bld(k), torch.from_numpy(bias))
    assert got.dtype == torch.float32 and got.shape == (3, 2, Lq)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_rowsum_dout_out_equals_rowsum_p_dp(rate):
    """rowsum(dO * O), which the backward kernel takes from the forward's
    output, is the JAX formula's D_i = rowsum(P * dP * f) under dropout
    too, because O = sum_k P f V: float64 under an explicit Philox keep
    mask."""
    B, H, Lq, Lk, D, seed = 2, 3, 11, 21, 16, 8
    rng = np.random.default_rng(4)
    q, k, v, bias = (a.astype(np.float64) for a in _attn_inputs(rng, B, H, Lq, Lk, D))
    do = rng.normal(size=(B, H, Lq, D))
    keep = philox_keep_mask_plain(seed, B, H, Lq, Lk, rate).numpy() if rate \
        else np.ones((B, H, Lq, Lk), bool)
    f = keep / (1.0 - rate)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(D) + bias[:, None, None, :]
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bhkd->bhqd", p * f, v)
    dp = np.einsum("bhqd,bhkd->bhqk", do, v) * f
    np.testing.assert_allclose((do * out).sum(-1), (p * dp).sum(-1), rtol=1e-12, atol=1e-12)


def test_attention_bwd_on_cpu_takes_the_forward_tensors():
    """The wrapper's signature: on the CPU the forward keeps its mask words
    (no lse) and the backward runs the plain backward under the mask it
    reads from them, which is the Philox mask of the forward's seed;
    without the words under dropout it refuses."""
    B, H, L, D, rate, seed = 2, 2, 7, 8, 0.2, 3
    rng = np.random.default_rng(9)
    q, k, v, bias = (torch.from_numpy(a) for a in _attn_inputs(rng, B, H, L, L, D))
    q, k, v = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    do = torch.randn(B, L, H, D)
    out, lse, words = attention._forward(q, k, v, bias, rate, seed, for_backward=True)
    assert lse is None and words.dtype == torch.int32 and words.shape == (B, H, L, 1)
    keep = philox_keep_mask_plain(seed, B, H, L, L, rate)
    want = attention_bwd_plain(q, k, v, bias, do, keep, rate)
    for g, r in zip(attention_bwd(q, k, v, bias, out, lse, words, do, rate), want):
        torch.testing.assert_close(g, r)
    with pytest.raises(ValueError, match="keep_words"):
        attention_bwd(q, k, v, bias, out, lse, None, do, rate)


@pytest.mark.parametrize("lk", [7, 32, 70])
def test_keep_words_round_trip(lk):
    """pack_keep_words puts key k at bit k % 32 of word k // 32 (the kernels'
    layout, zero past Lk), and unpack_keep_words gives the mask back."""
    keep = torch.from_numpy(np.random.default_rng(lk).random((2, 3, 5, lk)) < 0.5)
    words = attention.pack_keep_words(keep)
    assert words.dtype == torch.int32 and words.shape == (2, 3, 5, -(-lk // 32))
    w = words.numpy().astype(np.int64) & 0xFFFFFFFF
    for key in (0, lk // 2, lk - 1):
        np.testing.assert_array_equal((w[..., key // 32] >> (key % 32)) & 1,
                                      keep[..., key].numpy())
    assert not (w[..., -1] >> (lk - 32 * (words.shape[-1] - 1))).any()
    assert torch.equal(attention.unpack_keep_words(words, lk), keep)


def test_philox_known_answers():
    """Philox4x32-10 known-answer vectors of the Random123 distribution."""
    cases = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        assert tuple(int(w) for w in philox4x32_10_plain(ctr, key)) == want


def test_keep_rate_and_threshold():
    """keep iff (bits >> 8) * 2^-24 >= rate, evaluated in integers; over
    >= 10^6 draws the keep rate lies within 4 sigma of 1 - rate."""
    keep_min, scale = keep_threshold(0.1)
    assert keep_min == 1677722 and abs(scale - 1 / 0.9) < 1e-15
    assert keep_threshold(0.0) == (0, 1.0)
    mask = philox_keep_mask_plain(7, 4, 4, 256, 256, 0.1)
    n = mask.numel()
    assert n >= 10 ** 6
    sigma = (0.9 * 0.1 / n) ** 0.5
    assert abs(mask.float().mean().item() - 0.9) < 4 * sigma
