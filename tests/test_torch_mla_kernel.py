"""The two-width instance of the fused attention forward (#3) and backward
(#4): q and k 192 wide, v and the output 128 wide, with the caller's
softmax scale (DeepSeek-V2's latent attention, model/deepseek.py).

On the CPU the wrappers run their plain versions; these are held to a
float64 composition of softmax(q k^T scale + bias) v and to autograd of it
(1e-5: the plain versions compute in fp32). On the card the kernels are
held to the plain versions at the model's shapes, B 16 x 16 heads at L 256
and at L 50, each output within its share of the scale of each (batch,
head): 2^-6, two bf16 ulps, as for the one-width instances
(tests/test_torch_cuda.py). The file imports neither JAX nor the JAX
package.
"""

import math

import pytest
import torch

from k3m_tpu_torch.kernels import (
    attention, attention_bwd, attention_bwd_plain, attention_lse_plain, attention_plain,
    fused_attention, philox_keep_mask_plain,
)

DK, DV = 192, 128
SCALE = 1.2608 ** 2 / math.sqrt(DK)


def _inputs(B, H, L, device, dtype, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, L, H, DK, generator=g, device=device).to(dtype)
    k = torch.randn(B, L, H, DK, generator=g, device=device).to(dtype)
    v = torch.randn(B, L, H, DV, generator=g, device=device).to(dtype)
    do = torch.randn(B, L, H, DV, generator=g, device=device).to(dtype)
    bias = torch.zeros(B, L, device=device)
    for b in range(1, B):
        bias[b, L - (2 + b) % L:] = -10000.0
    return q, k, v, bias, do


def _composed(q, k, v, bias, scale):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + bias[:, None, None, :]
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def test_two_width_plain_forward_and_backward_match_composition():
    q, k, v, bias, do = _inputs(2, 3, 11, "cpu", torch.float32)
    qd, kd, vd = (t.double().requires_grad_(True) for t in (q, k, v))
    want = _composed(qd, kd, vd, bias.double(), SCALE)
    want.backward(do.double())
    qf, kf, vf = (t.clone().requires_grad_(True) for t in (q, k, v))
    got = fused_attention(qf, kf, vf, bias, scale=SCALE)
    assert got.shape == (2, 11, 3, DV)
    torch.testing.assert_close(got.double(), want.detach(), rtol=0, atol=1e-5)
    got.backward(do)
    for a, r in ((qf, qd), (kf, kd), (vf, vd)):
        torch.testing.assert_close(a.grad.double(), r.grad, rtol=0, atol=1e-5)
    # the default scale stays 1 / sqrt(D) of q's width
    torch.testing.assert_close(attention_plain(q, k, v, bias).double(),
                               _composed(q.double(), k.double(), v.double(), bias.double(),
                                         1 / math.sqrt(DK)), rtol=0, atol=1e-5)


def test_two_width_operands_checked():
    q, k, v, bias, _ = _inputs(1, 2, 8, "cpu", torch.bfloat16)
    with pytest.raises(ValueError, match="not in"):
        attention.check_operands(q, k, v[..., :96], bias, "fused_attention")
    with pytest.raises(TypeError, match="bf16 only"):
        attention.check_operands(q.float(), k.float(), v.float(), bias, "fused_attention")
    attention.check_operands(q, k, v, bias, "fused_attention")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _check(got, want):
    """Within 2^-6 of the scale of each (batch, head), a head's scale at
    least 1e-3 of the tensor's (tests/test_torch_cuda.py `_check_bwd`)."""
    r = want.float()
    scale = r.abs().amax(dim=(1, 3), keepdim=True)
    tol = 2.0 ** -6 * scale.clamp(min=1e-3 * float(r.abs().max()))
    assert bool(((got.float() - r).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("L", [256, 50])
def test_cuda_two_width_attention_matches_plain(cuda_device, L):
    """Forward, lse and backward at B 16 x 16 heads, the model's shapes,
    from the projections' strided views (v a view at row stride H * 256, as
    the latent attention takes it)."""
    B, H = 16, 16
    q, k, _, bias, do = _inputs(B, H, L, cuda_device, torch.bfloat16, seed=L)
    kv = torch.randn(B, L, H, 2 * DV, device=cuda_device).to(torch.bfloat16)
    v = kv[..., DV:]
    out, lse, words = attention._forward(q, k, v, bias, 0.0, 0, for_backward=True,
                                         scale=SCALE)
    assert words is None and out.shape == (B, L, H, DV)
    _check(out, attention_plain(q, k, v, bias, scale=SCALE))
    ref = attention_lse_plain(q, k, bias, scale=SCALE)
    assert bool(((lse - ref).abs() <= 1e-5 * ref.abs().clamp(min=1.0)).all())
    got = attention_bwd(q, k, v, bias, out, lse, None, do, scale=SCALE)
    want = attention_bwd_plain(q, k, v, bias, do, scale=SCALE)
    assert [t.shape[-1] for t in got] == [DK, DK, DV]
    for a, r in zip(got, want):
        _check(a, r)
    again = attention_bwd(q, k, v, bias, out, lse, None, do, scale=SCALE)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_two_width_attention_with_dropout(cuda_device):
    """Under dropout the kernel draws philox_keep_mask_plain's mask, and the
    backward fed the words it kept matches the plain backward."""
    B, H, L, rate, seed = 2, 4, 70, 0.1, 5
    q, k, v, bias, do = _inputs(B, H, L, cuda_device, torch.bfloat16, seed=7)
    keep = philox_keep_mask_plain(seed, B, H, L, L, rate, 0, cuda_device)
    out, lse, words = attention._forward(q, k, v, bias, rate, seed, for_backward=True,
                                         scale=SCALE)
    _check(out, attention_plain(q, k, v, bias, keep, rate, scale=SCALE))
    got = attention_bwd(q, k, v, bias, out, lse, words, do, rate, scale=SCALE)
    for a, r in zip(got, attention_bwd_plain(q, k, v, bias, do, keep, rate, scale=SCALE)):
        _check(a, r)
