"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card and skips without one. The file
imports neither JAX nor the JAX package, so on a machine with a card and
no JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import pytest
import torch

from k3m_tpu_torch import kernels
from k3m_tpu_torch.kernels import (
    attention, attention_bwd, attention_bwd_plain, attention_lse_plain, attention_plain,
    biattention_plain, coattn, fused_attention, fused_biattention, fused_layernorm,
    layernorm_bwd, layernorm_bwd_plain, layernorm_plain, philox_keep_mask_plain,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype):
    """Each CUDA kernel against its plain version on the card, within a
    share of the output scale: 2e-5 in fp32; 2^-6 (two bf16 ulps) in bf16,
    where the attention kernels round the probabilities and the output."""
    share = 2e-5 if dtype == torch.float32 else 2.0 ** -6

    def check(got, want):
        want = want.float()
        tol = share * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)

    g = torch.Generator(device=cuda_device).manual_seed(0)
    kernels.reset_launch_counts()
    x = torch.randn(6, 50, 768, generator=g, device=cuda_device).to(dtype)
    s = torch.randn(768, generator=g, device=cuda_device)
    check(fused_layernorm(x, s, s, x), layernorm_plain(x, s, s, x))
    for (L1, L2, D) in ((37, 50, 128), (256, 50, 96), (50, 50, 64)):
        qkv1 = torch.randn(2, L1, 3, 4, D, generator=g, device=cuda_device).to(dtype)
        qkv2 = torch.randn(2, L2, 3, 4, D, generator=g, device=cuda_device).to(dtype)
        b1 = torch.zeros(2, L1, device=cuda_device)
        b1[1, L1 // 2:] = -10000.0
        b2 = torch.zeros(2, L2, device=cuda_device)
        args = (*qkv1.unbind(2), b1, *qkv2.unbind(2), b2)
        for got, want in zip(fused_biattention(*args), biattention_plain(*args)):
            check(got, want)
        q, k, v = qkv2.unbind(2)
        check(fused_attention(q, k, v, b2), attention_plain(q, k, v, b2))
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"fused_layernorm": 1, "layernorm_bwd": 0,
                                       "fused_attention": 3, "attention_bwd": 0,
                                       "fused_biattention": 3}


@pytest.mark.cuda
def test_cuda_bf16_attention_refuses_misaligned_rows(cuda_device):
    """The tensor-core tiles read 16-byte rows: a bf16 view whose rows are
    not 16-byte aligned is refused, not computed, by the forward and by the
    backward."""
    x = torch.zeros(2, 9, 2, 65, device=cuda_device, dtype=torch.bfloat16)[..., :64]
    b = torch.zeros(2, 9, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        fused_attention(x, x, x, b)
    lse = torch.zeros(2, 2, 9, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        attention_bwd(x, x, x, b, x, lse, None, x)


def _share(dtype):
    return 2e-5 if dtype == torch.float32 else 2.0 ** -6


def _check(got, want, share):
    want = want.float()
    tol = share * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_layernorm_backward_matches_plain(cuda_device, dtype):
    """dx within the forward's share of its scale; dscale/dbias (sums over
    all rows, in fp32) within 1e-4 of theirs."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    y = torch.randn(300, 768, generator=g, device=cuda_device).to(dtype)
    dy = torch.randn(300, 768, generator=g, device=cuda_device).to(dtype)
    rstd = torch.rand(300, generator=g, device=cuda_device) + 0.5
    s = torch.randn(768, generator=g, device=cuda_device)
    b = torch.randn(768, generator=g, device=cuda_device)
    got = layernorm_bwd(y, rstd, s, b, dy, dtype)
    want = layernorm_bwd_plain(y, rstd, s, b, dy, dtype)
    _check(got[0], want[0], _share(dtype))
    for a, r in zip(got[1:], want[1:]):
        _check(a, r, 1e-4)
    assert layernorm_bwd.launches >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_attention_with_dropout_matches_plain(cuda_device, dtype, rate):
    """Forward and backward kernels against the plain versions under the
    Philox mask of philox_keep_mask_plain; each backward output within its
    share of the scale of each (batch, head), 1e-4 in fp32 (dS cancels),
    2^-6 in bf16 (its inputs are bf16, its sums fp32), so that a large
    gradient of one head cannot hide a wrong one of another; a head's scale
    is at least 1e-2 (fp32) or 1e-3 (bf16) of the tensor's, as in
    chip_smoke.bwd_errors."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    B, H, Lq, Lk, D, seed = 2, 4, 50, 37, 64, 99
    q = torch.randn(B, Lq, H, D, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(B, Lk, H, D, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(B, Lk, H, D, generator=g, device=cuda_device).to(dtype)
    do = torch.randn(B, Lq, H, D, generator=g, device=cuda_device).to(dtype)
    bias = torch.zeros(B, Lk, device=cuda_device)
    bias[1, 20:] = -10000.0
    keep = philox_keep_mask_plain(seed, B, H, Lq, Lk, rate, 0, cuda_device) \
        if rate else None
    _check(fused_attention(q, k, v, bias, dropout_rate=rate, seed=seed),
           attention_plain(q, k, v, bias, keep, rate), _share(dtype))
    out, lse, words = attention._forward(q, k, v, bias, rate, seed, for_backward=True)
    _check_bwd(attention_bwd(q, k, v, bias, out, lse, words, do, rate),
               attention_bwd_plain(q, k, v, bias, do, keep, rate), dtype)


def _check_bwd(got, want, dtype):
    """Each backward output within its share of the scale of each (batch,
    head), as in chip_smoke.bwd_errors."""
    share, floor = (1e-4, 1e-2) if dtype == torch.float32 else (2.0 ** -6, 1e-3)
    for a, r in zip(got, want):
        r = r.float()
        scale = r.abs().amax(dim=(1, 3), keepdim=True)      # per (batch, head)
        tol = share * scale.clamp(min=floor * float(r.abs().max()))
        assert bool(((a.float() - r).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_lse_and_the_backward_it_drives(cuda_device, dtype):
    """The row log-sum-exp both directions of the bi-attention kernel write
    for the backward, within 1e-5 of max(1, |lse|) of attention_lse_plain;
    the mask words it keeps, bit for bit those of philox_keep_mask_plain;
    and the backward fed what the forward kept
    against the plain backward (which needs none of it), at rate 0.1; two
    calls of the backward give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    B, H, L1, L2, D, rate, seed = 2, 4, 37, 70, 128, 0.1, 21
    q1, k1, v1 = torch.randn(3, B, L1, H, D, generator=g, device=cuda_device).to(dtype)
    q2, k2, v2 = torch.randn(3, B, L2, H, D, generator=g, device=cuda_device).to(dtype)
    b1 = torch.zeros(B, L1, device=cuda_device)
    b1[1, 5:] = -10000.0
    b2 = torch.zeros(B, L2, device=cuda_device)
    b2[0, 66:] = -10000.0
    c1, _, (lse1, words1), (lse2, words2) = coattn._forward(
        q1, k1, v1, b1, q2, k2, v2, b2, rate, rate, seed, for_backward=True)
    bits = torch.arange(32, device=cuda_device, dtype=torch.int32)
    for lse, words, (q, k, b), salt in ((lse1, words1, (q2, k1, b1), 0),
                                        (lse2, words2, (q1, k2, b2), 7919)):
        ref = attention_lse_plain(q, k, b)
        assert bool(((lse - ref).abs() <= 1e-5 * ref.abs().clamp(min=1.0)).all())
        mask = ((words[..., None] >> bits) & 1).bool().reshape(*words.shape[:-1], -1)
        keep = philox_keep_mask_plain(seed, B, H, q.shape[1], k.shape[1], rate, salt,
                                      cuda_device)
        assert torch.equal(mask[..., :k.shape[1]], keep)
    do1 = torch.randn(B, L2, H, D, generator=g, device=cuda_device).to(dtype)
    keep1 = philox_keep_mask_plain(seed, B, H, L2, L1, rate, 0, cuda_device)
    got = attention_bwd(q2, k1, v1, b1, c1, lse1, words1, do1, rate)
    _check_bwd(got, attention_bwd_plain(q2, k1, v1, b1, do1, keep1, rate), dtype)
    again = attention_bwd(q2, k1, v1, b1, c1, lse1, words1, do1, rate)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_dropout_mask_is_the_plain_mask(cuda_device):
    """With q = 0 and v the one-hot rows of the identity, the forward's
    output is keep / D * scale over a window of D unmasked keys, so the
    kernels' mask can be read back and held to philox_keep_mask_plain bit
    for bit: self-attention (salt 0) and co-attention direction 2 (salt
    7919)."""
    B, H, L, D, seed, rate = 2, 3, 64, 64, 5, 0.1
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(B, L, H, D, device=cuda_device, dtype=dtype)
        v = torch.eye(D, device=cuda_device, dtype=dtype)[None, :, None, :].expand(
            B, L, H, D).contiguous()
        bias = torch.zeros(B, L, device=cuda_device)
        out = fused_attention(q, q, v, bias, dropout_rate=rate, seed=seed)
        got = (out.float() > 0).permute(0, 2, 1, 3)
        assert torch.equal(got, philox_keep_mask_plain(seed, B, H, L, L, rate, 0,
                                                       cuda_device))
        _, out2 = fused_biattention(q, q, v, bias, q, q, v, bias, dropout2=rate, seed=seed)
        got2 = (out2.float() > 0).permute(0, 2, 1, 3)
        assert torch.equal(got2, philox_keep_mask_plain(seed, B, H, L, L, rate, 7919,
                                                        cuda_device))
