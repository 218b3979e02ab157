"""The port's kernel modules (k3m_tpu_torch/kernels) against the JAX
package's Pallas kernels in interpret mode, on the same numpy arrays.

On the CPU each wrapper runs its plain PyTorch version, so these tests hold
the arithmetic the CUDA kernels implement to the TPU kernels' outputs. The
CUDA kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py and by chip_smoke.py.

Tolerances: 1e-5 in fp32 (the same sums in another order); 1e-2 where the
output is cast to bf16 (one bf16 rounding of values of order 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k3m_tpu.kernels.attention import padded_fused_attention
from k3m_tpu.kernels.coattn import padded_fused_biattention
from k3m_tpu.kernels.layernorm import fused_layernorm as jax_layernorm
from k3m_tpu_torch import kernels
from k3m_tpu_torch.kernels import (
    attention_plain, fused_attention, fused_biattention,
    fused_layernorm, layernorm_plain,
)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


# ------------------------------------------------------------- LayerNorm

def _ln_inputs(shape, with_res, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32) if with_res else None
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, res, scale, bias


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("shape,with_res", [
    ((4, 37, 768), True),     # image-stream rows
    ((4, 50, 768), False),    # text stream, no residual
    ((2, 256, 1024), True),   # pv-length rows, image width
    ((3, 7, 96), True),       # narrow rows
])
def test_layernorm_matches_pallas(shape, with_res):
    x, res, scale, bias = _ln_inputs(shape, with_res, seed=5)
    out = fused_layernorm(_t(x), _t(scale), _t(bias), _t(res))
    ref = jax_layernorm(_j(x), _j(scale), _j(bias), _j(res), interpret=True)
    assert out.dtype == torch.float32 and out.shape == shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32_TOL)


def test_layernorm_out_dtype_cast_matches_pallas():
    x, res, scale, bias = _ln_inputs((2, 16, 768), True, seed=7)
    out = fused_layernorm(_t(x), _t(scale), _t(bias), _t(res),
                          out_dtype=torch.bfloat16)
    ref = jax_layernorm(_j(x), _j(scale), _j(bias), _j(res),
                        out_dtype=jnp.bfloat16, interpret=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **BF16_TOL)


def test_layernorm_bf16_residual_matches_pallas():
    """The image-embedding LN: fp32-statistics over a bf16 input plus a
    bf16 residual (the location projection), written as bf16."""
    x, res, scale, bias = _ln_inputs((2, 37, 1024), True, seed=8)
    xb, rb = torch.from_numpy(x).bfloat16(), torch.from_numpy(res).bfloat16()
    out = fused_layernorm(xb, _t(scale), _t(bias), rb)
    ref = jax_layernorm(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                        _j(scale), _j(bias),
                        jnp.asarray(rb.float().numpy(), jnp.bfloat16),
                        interpret=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **BF16_TOL)


# ------------------------------------------------------------- attention

def _attn_inputs(B, H, Lq, Lk, D, seed, n_masked=3):
    """q/k/v in the Pallas layout [B, H, L, D] and a [B, Lk] key bias with
    the last keys masked (a different count per batch row)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Lq, D)).astype(np.float32)
    k = rng.normal(size=(B, H, Lk, D)).astype(np.float32)
    v = rng.normal(size=(B, H, Lk, D)).astype(np.float32)
    mask = np.ones((B, Lk), np.float32)
    for b in range(B):
        mask[b, Lk - min(n_masked + b, Lk - 1):] = 0
    return q, k, v, ((1 - mask) * -10000.0).astype(np.float32)


def _bld(a):
    """[B, H, L, D] numpy -> the port's [B, L, H, D] torch layout."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))


def _pallas_attention(q, k, v, bias):
    out = padded_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(bias[:, None, None, :]),
                                 interpret=True)
    return np.asarray(out).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,H,Lq,Lk,D", [
    (2, 3, 16, 24, 8),        # tests/test_kernels.py geometry
    (2, 3, 13, 37, 8),        # odd lengths
    (2, 2, 50, 50, 64),       # text stream
    (2, 2, 37, 37, 128),      # image stream
    (2, 2, 19, 11, 96),       # D = 96 (8 heads over 768)
    (2, 2, 1, 37, 64),        # one query row
    (2, 2, 50, 1, 128),       # one key
    (2, 2, 65, 65, 64),       # a 64-row tile and one more row and key
])
def test_attention_matches_pallas(B, H, Lq, Lk, D):
    q, k, v, bias = _attn_inputs(B, H, Lq, Lk, D, seed=B * Lq + D)
    out = fused_attention(_bld(q), _bld(k), _bld(v), torch.from_numpy(bias))
    assert out.shape == (B, Lq, H, D)
    np.testing.assert_allclose(out.numpy(), _pallas_attention(q, k, v, bias),
                               **F32_TOL)


@pytest.mark.parametrize("L1,L2,D", [(11, 19, 8), (37, 50, 128), (50, 13, 96),
                                     (1, 65, 64), (65, 1, 128)])
def test_biattention_matches_pallas(L1, L2, D):
    B, H = 2, 2
    q1, k1, v1, b1 = _attn_inputs(B, H, L1, L1, D, seed=1)
    q2, k2, v2, b2 = _attn_inputs(B, H, L2, L2, D, seed=2)
    c1, c2 = fused_biattention(_bld(q1), _bld(k1), _bld(v1), torch.from_numpy(b1),
                               _bld(q2), _bld(k2), _bld(v2), torch.from_numpy(b2))
    j = lambda a: jnp.asarray(a)
    r1, r2 = padded_fused_biattention(
        j(q1), j(k1), j(v1), j(b1[:, None, None, :]),
        j(q2), j(k2), j(v2), j(b2[:, None, None, :]), interpret=True)
    # direction order: ctx1 is stream-2 queries over stream 1 (bias1)
    assert c1.shape == (B, L2, H, D) and c2.shape == (B, L1, H, D)
    np.testing.assert_allclose(c1.numpy(), np.asarray(r1).transpose(0, 2, 1, 3),
                               **F32_TOL)
    np.testing.assert_allclose(c2.numpy(), np.asarray(r2).transpose(0, 2, 1, 3),
                               **F32_TOL)


def test_attention_takes_strided_heads():
    """Q/K/V as strided views of one packed projection give the same
    result as contiguous copies."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(2, 9, 3, 2, 8)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    bias = torch.zeros(2, 9)
    torch.testing.assert_close(fused_attention(q, k, v, bias),
                               attention_plain(q.contiguous(), k.contiguous(),
                                               v.contiguous(), bias))


# ------------------------------------------------------ wrapper contract

def test_cpu_tensors_run_the_plain_version_and_count_nothing():
    kernels.reset_launch_counts()
    x, res, scale, bias = _ln_inputs((3, 5, 32), True, seed=1)
    out = fused_layernorm(_t(x), _t(scale), _t(bias), _t(res))
    torch.testing.assert_close(out, layernorm_plain(_t(x), _t(scale), _t(bias), _t(res)))
    q, k, v, b = _attn_inputs(1, 2, 4, 4, 8, seed=2)
    q, k, v, b = _bld(q).requires_grad_(), _bld(k), _bld(v), torch.from_numpy(b)
    fused_attention(q, k, v, b, dropout_rate=0.1, seed=3).sum().backward()
    sum(fused_biattention(q, k, v, b, q, k, v, b, dropout1=0.1)).sum().backward()
    assert kernels.launch_counts() == {name: 0 for name in kernels.WRAPPERS}
    assert set(kernels.WRAPPERS) == {"fused_layernorm", "layernorm_bwd", "fused_attention",
                                     "attention_bwd", "fused_biattention"}


def test_dropout_is_refused():
    """A dropout rate outside [0, 1) is refused, not computed."""
    q = torch.zeros(1, 4, 2, 8)
    b = torch.zeros(1, 4)
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError):
            fused_attention(q, q, q, b, dropout_rate=rate)
        with pytest.raises(ValueError):
            fused_biattention(q, q, q, b, q, q, q, b, dropout2=rate)


def test_other_devices_never_fall_back():
    """A tensor that is neither on the CPU nor on a CUDA card is refused,
    not computed by the plain version."""
    x = torch.zeros(4, 32, device="meta")
    p = torch.zeros(32, device="meta")
    with pytest.raises(ValueError):
        fused_layernorm(x, p, p)
    q = torch.zeros(1, 4, 2, 8, device="meta")
    b = torch.zeros(1, 4, device="meta")
    with pytest.raises(ValueError):
        fused_attention(q, q, q, b)
    with pytest.raises(ValueError):
        fused_biattention(q, q, q, b, q, q, q, b)
