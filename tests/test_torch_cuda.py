"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card and skips without one. The file
imports neither JAX nor the JAX package, so on a machine with a card and
no JAX it runs on its own:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from k3m_tpu_torch import kernels
from k3m_tpu_torch.kernels import (
    attention, attention_bwd, attention_bwd_plain, attention_lse_plain, attention_plain,
    biattention_plain, coattn, fused_attention, fused_biattention, fused_layernorm,
    layernorm_bwd, layernorm_bwd_plain, layernorm_plain, philox_keep_mask_plain,
)

EDGE_LENGTHS = (1, 16, 37, 50, 64, 65, 129, 256)


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
@pytest.mark.parametrize("rows,n", [(300, 2048), (4099, 2048), (77, 1032)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_layernorm_backward_matches_plain_on_wide_rows(cuda_device, rows, n, dtype):
    """Rows wider than 1,024 columns (the DeepSeek-V2 text block's 2048-wide
    co-attention and head LayerNorms) take the backward's wide kernel, held
    as the narrow one is above, and give the same bits twice."""
    g = torch.Generator(device=cuda_device).manual_seed(rows + n)
    y = torch.randn(rows, n, generator=g, device=cuda_device).to(dtype)
    dy = torch.randn(rows, n, generator=g, device=cuda_device).to(dtype)
    rstd = torch.rand(rows, generator=g, device=cuda_device) + 0.5
    s = torch.randn(n, generator=g, device=cuda_device)
    b = torch.randn(n, generator=g, device=cuda_device)
    launches = layernorm_bwd.launches
    got = layernorm_bwd(y, rstd, s, b, dy, dtype)
    again = layernorm_bwd(y, rstd, s, b, dy, dtype)
    want = layernorm_bwd_plain(y, rstd, s, b, dy, dtype)
    _check(got[0], want[0], _share(dtype))
    for a, r in zip(got[1:], want[1:]):
        _check(a, r, 1e-4)
    assert all(torch.equal(a, r) for a, r in zip(got, again))
    assert layernorm_bwd.launches == launches + 2


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


def _packed(B, L, H, D, dtype, g, device):
    """q, k, v as strided [B, L, H, D] views of one packed projection."""
    qkv = torch.randn(B, L, 3, H, D, generator=g, device=device).to(dtype)
    return qkv.unbind(2)


def _ragged(B, L, g, device):
    lengths = torch.randint(1, L + 1, (B,), generator=g, device=device)
    lengths[0] = L
    return (torch.arange(L, device=device)[None, :] >= lengths[:, None]).float() * -10000.0


def _check_kept(lse, words, q, k, bias, keep):
    """lse within 1e-5 of max(1, |lse|) of attention_lse_plain; the mask
    words bit for bit those of philox_keep_mask_plain (where it drops)."""
    ref = attention_lse_plain(q, k, bias)
    assert bool(((lse - ref).abs() <= 1e-5 * ref.abs().clamp(min=1.0)).all())
    if keep is not None:
        bits = torch.arange(32, device=words.device, dtype=torch.int32)
        mask = ((words[..., None] >> bits) & 1).bool().reshape(*words.shape[:-1], -1)
        assert torch.equal(mask[..., :keep.shape[-1]], keep)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("D", [64, 96, 128])
def test_cuda_attention_forward_edges(cuda_device, D, rate, dtype):
    """The self-attention forward at the edges of its tile, every Lq x Lk
    over one query row or key, a key tile and one more, a 64-row CTA and
    one more row, 8-warp CTAs: output, lse and mask words."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    B, H, seed = 2, 3, 31
    for Lq in EDGE_LENGTHS:
        for Lk in EDGE_LENGTHS:
            q = _packed(B, Lq, H, D, dtype, g, cuda_device)[0]
            k, v = _packed(B, Lk, H, D, dtype, g, cuda_device)[1:]
            bias = _ragged(B, Lk, g, cuda_device)
            keep = philox_keep_mask_plain(seed, B, H, Lq, Lk, rate, 0, cuda_device) \
                if rate else None
            out, lse, words = attention._forward(q, k, v, bias, rate, seed, for_backward=True)
            _check(out, attention_plain(q, k, v, bias, keep, rate), _share(dtype))
            _check_kept(lse, words, q, k, bias, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("L1,L2,D", [(37, 50, 128), (37, 256, 128), (256, 50, 96),
                                     (1, 65, 64)])
def test_cuda_biattention_forward_edges(cuda_device, L1, L2, D, rate, dtype):
    """The bi-attention forward at the model's three shapes and at one row
    against 65 keys: both directions' outputs, lse and mask words."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    B, H, seed = 2, 3, 37
    q1, k1, v1 = _packed(B, L1, H, D, dtype, g, cuda_device)
    q2, k2, v2 = _packed(B, L2, H, D, dtype, g, cuda_device)
    b1, b2 = _ragged(B, L1, g, cuda_device), _ragged(B, L2, g, cuda_device)
    args = (q1, k1, v1, b1, q2, k2, v2, b2)
    m1 = philox_keep_mask_plain(seed, B, H, L2, L1, rate, 0, cuda_device) if rate else None
    m2 = philox_keep_mask_plain(seed, B, H, L1, L2, rate, 7919, cuda_device) if rate else None
    c1, c2, (lse1, w1), (lse2, w2) = coattn._forward(*args, rate, rate, seed,
                                                     for_backward=True)
    for got, want in zip((c1, c2), biattention_plain(*args, m1, m2, rate, rate)):
        _check(got, want, _share(dtype))
    _check_kept(lse1, w1, q2, k1, b1, m1)
    _check_kept(lse2, w2, q1, k2, b2, m2)


def _pair_item(rng, B, L, Lpv, R, P, vocab, feat):
    return dict(
        input_ids=rng.integers(1, vocab, (B, L)), input_mask=np.ones((B, L), np.int64),
        segment_ids=np.zeros((B, L), np.int64),
        input_ids_pv=rng.integers(1, vocab, (B, Lpv)),
        input_mask_pv=np.ones((B, Lpv), np.int64), segment_ids_pv=np.zeros((B, Lpv), np.int64),
        index_p=rng.integers(1, Lpv, (B, P, 2)), index_v=rng.integers(1, Lpv, (B, P, 2)),
        image_feat=rng.random((B, R, feat), dtype=np.float32),
        image_loc=rng.random((B, R, 5), dtype=np.float32), image_mask=np.ones((B, R), np.int64))


@pytest.mark.cuda
def test_cuda_finetune_train_step(cuda_device):
    """One bf16 finetune train step of the bert_base_6layer_6conect model
    at batch 4 and the main path's lengths (run_finetune_item_alignment.sh:
    inner loss, fusion strategy 1, dropout 0.1): the loss is finite and
    every kernel ran its count, forward and backward: per item the
    serving forward's launches, a backward for each LayerNorm and attention
    and two for each bi-attention."""
    from pathlib import Path

    from k3m_tpu_torch.config import K3MConfig
    from k3m_tpu_torch.train.alignment_loop import AlignmentTrainer
    cfg = K3MConfig.from_json_file(str(
        Path(kernels.__file__).parents[1] / "configs" / "bert_base_6layer_6conect.json")
    ).replace(use_image=True, with_coattention=True, loss_type="inner", if_pre_sampling=1,
              dtype="bfloat16")
    rng = np.random.default_rng(0)
    B = 4
    shape = (B, 50, 256, 37, 30, cfg.vocab_size, cfg.v_feature_size)
    batch = dict(label=(np.arange(B) % 2).astype(np.float32),
                 item1=_pair_item(rng, *shape), item2=_pair_item(rng, *shape))
    trainer = AlignmentTrainer(cfg, seed=3, device=cuda_device)
    kernels.reset_launch_counts()
    loss, probs = trainer.train_step(batch)
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and probs.shape == (B,)
    text, image, conn = 4 * cfg.num_hidden_layers, 2 * cfg.v_num_hidden_layers, \
        3 * cfg.num_coattention_layers
    ln = 3 + 2 * (text + image) + 4 * conn
    assert kernels.launch_counts() == {
        "fused_layernorm": 2 * ln, "layernorm_bwd": 2 * ln,
        "fused_attention": 2 * (text + image), "attention_bwd": 2 * (text + image + 2 * conn),
        "fused_biattention": 2 * conn}
