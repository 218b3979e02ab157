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
    attention_plain, biattention_plain, fused_attention, fused_biattention,
    fused_layernorm, layernorm_plain,
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
    assert kernels.launch_counts() == {"fused_layernorm": 1, "fused_attention": 3,
                                       "fused_biattention": 3}


@pytest.mark.cuda
def test_cuda_bf16_attention_refuses_misaligned_rows(cuda_device):
    """The tensor-core tile reads 16-byte rows: a bf16 view whose rows are
    not 16-byte aligned is refused, not computed."""
    x = torch.zeros(2, 9, 2, 65, device=cuda_device, dtype=torch.bfloat16)[..., :64]
    b = torch.zeros(2, 9, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        fused_attention(x, x, x, b)
