"""The port's pretraining modules against the JAX package's, in fp32 on
the CPU with the same weights (carried by from_jax_params) and the same
numpy inputs: the two repairs (the straight-through Gumbel gradient, fp32
training parameters), the chunked MLM loss, the pretraining heads, the
masked-RoI losses and the LPM loss with injected negatives. Tolerance
2e-5: fp32 on both sides, the same arithmetic summed in another order.
The whole model is held to the JAX package in
tests/test_torch_pretrain_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k3m_tpu.model import fusion as jfu
from k3m_tpu.model import heads as jhd
from k3m_tpu.model import pretrain as jpt
from k3m_tpu.model import structure as jst
from k3m_tpu_torch.model import fusion as tfu
from k3m_tpu_torch.model import heads as thd
from k3m_tpu_torch.model import pretrain as tpt
from k3m_tpu_torch.model import structure as tst
from tests.conftest import MICRO, NANO
from tests.test_torch_modules import normal, port_module, redraw, torch_config

TOL = dict(rtol=2e-5, atol=2e-5)


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j),
                               **(tol or TOL))


# --------------------------------------------------- repair: Gumbel STE

def test_gumbel_softmax_hard_gradient_matches_jax():
    """The straight-through estimator passes the soft sample's gradient to
    the logits under a fixed injected noise (y_hard + y_soft -
    stop_gradient(y_soft)); without the detach the gradient is zero."""
    rng = np.random.default_rng(0)
    logits, noise = normal(rng, 2, 5, 3, 4), normal(rng, 2, 5, 3, 4)
    w = normal(rng, 2, 5, 3, 4)
    want = jax.grad(lambda x: (jfu.gumbel_softmax_hard(
        x, None, axis=2, noise=jnp.asarray(noise)) * w).sum())(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    y = tfu.gumbel_softmax_hard(x, torch.from_numpy(noise), dim=2)
    (y * torch.from_numpy(w)).sum().backward()
    assert float(np.abs(np.asarray(want)).max()) > 1e-3
    close(x.grad, want)
    close(y, jfu.gumbel_softmax_hard(jnp.asarray(logits), None, axis=2,
                                     noise=jnp.asarray(noise)))


# ------------------------------------------ repair: training precision

def test_training_keeps_fp32_parameters_and_casts_per_use():
    """Under bf16 compute the pretraining model keeps fp32 parameters (the
    AdamW master weights) and every Linear computes in bf16 at each use;
    gradients arrive in fp32. Serving still casts its Linears once."""
    from k3m_tpu_torch.model.alignment import build_model
    cfg = torch_config(NANO).replace(dtype="bfloat16")
    model = tpt.build_pretraining_model(cfg, seed=0, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    lin = model.cls.imagePredictions.decoder
    x = torch.randn(2, cfg.v_hidden_size, dtype=torch.bfloat16)
    y = lin(x)
    assert y.dtype == torch.bfloat16 and lin.weight.dtype == torch.float32
    y.float().sum().backward()
    assert lin.weight.grad.dtype == torch.float32
    served = build_model(cfg.replace(loss_type="ce"), seed=0, device="cpu")
    assert served.classifier.dense.weight.dtype == torch.bfloat16


# ------------------------------------------------------------ heads

@pytest.mark.parametrize("L,chunk", [(13, 4), (12, 12), (5, 8)])
def test_chunked_masked_ce_matches_jax(L, chunk):
    rng = np.random.default_rng(L)
    B, D, V = 3, 16, 50
    x, table, bias = normal(rng, B, L, D), normal(rng, V, D), normal(rng, V)
    labels = np.where(rng.random((B, L)) < 0.4, rng.integers(0, V, (B, L)), -1)
    labels = labels.astype(np.int32)
    want = jhd.chunked_masked_ce(*map(jnp.asarray, (x, table, bias, labels)), chunk)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, table, bias)]
    got = thd.chunked_masked_ce(*ts, torch.from_numpy(labels).long(), chunk)
    close(got, want)
    gw = jax.grad(lambda a, b, c: jhd.chunked_masked_ce(a, b, c, jnp.asarray(labels),
                                                        chunk), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, table, bias)))
    got.backward()
    for t, g in zip(ts, gw):
        close(t.grad, g)


def test_pretraining_heads_match_jax():
    cfg = MICRO
    rng = np.random.default_rng(1)
    B, L, Lpv, R = 2, 6, 9, 4
    H, V = cfg.hidden_size, cfg.v_hidden_size
    ins = [normal(rng, B, L, H), normal(rng, B, R, V), normal(rng, B, H),
           normal(rng, B, H), normal(rng, B, Lpv, H), normal(rng, B, H),
           normal(rng, cfg.vocab_size, H)]
    lt = np.where(rng.random((B, L)) < 0.5, rng.integers(0, cfg.vocab_size, (B, L)), -1)
    lpv = np.where(rng.random((B, Lpv)) < 0.5,
                   rng.integers(0, cfg.vocab_size, (B, Lpv)), -1)
    jm = jhd.PreTrainingHeads(cfg)
    kw = dict(deterministic=True, lm_labels_t=lt, lm_labels_pv=lpv)
    p = redraw(jm.init(jax.random.PRNGKey(0), *ins, **kw)["params"], 2)
    tm = port_module(thd.PreTrainingHeads(torch_config(cfg)), p, "cls/", "cls.")
    want = jm.apply({"params": p}, *ins, **kw)
    got = tm(*map(torch.from_numpy, ins), torch.from_numpy(lt), torch.from_numpy(lpv),
             deterministic=True)
    for g, r in zip(got, want):
        close(g, r)


@pytest.mark.parametrize("visual_target", [0, 1, 2])
def test_masked_image_loss_matches_jax(visual_target):
    cfg = MICRO.replace(visual_target=visual_target, num_negative_image=10)
    rng = np.random.default_rng(visual_target)
    B, R, T = 3, 5, 7
    scores = normal(rng, B, R, T)
    target = rng.random((B, R, T)).astype(np.float32)
    target[0, 0, :3] = 0.0                         # xlogy(0, 0) = 0
    label = np.where(rng.random((B, R)) < 0.5, 1, -1).astype(np.int32)
    neg = rng.integers(0, B * R, (B, R, 10)) if visual_target == 2 else None
    want = jpt.masked_image_loss(cfg, jnp.asarray(scores), jnp.asarray(label),
                                 jnp.asarray(target), None,
                                 neg_index=None if neg is None else jnp.asarray(neg))
    got = tpt.masked_image_loss(torch_config(cfg), torch.from_numpy(scores),
                                torch.from_numpy(label), torch.from_numpy(target),
                                neg_index=None if neg is None else torch.from_numpy(neg))
    close(got, want)


@pytest.mark.parametrize("fix_bugs", [False, True])
def test_lpm_loss_matches_jax(fix_bugs):
    """LPM with injected negatives, both margin conventions; item 1 has no
    pv pairs and item 0 one pair (no value negative), and entity draws
    that hit the item itself are masked out."""
    cfg = NANO.replace(fix_reference_bugs=fix_bugs, num_negative_pv=4)
    rng = np.random.default_rng(4)
    B, Lpv, P, H = 4, 12, 4, cfg.hidden_size
    c0, seq = normal(rng, B, H), normal(rng, B, Lpv, H)
    index_p = rng.integers(1, Lpv, (B, P, 2)).astype(np.int32)
    index_v = rng.integers(1, Lpv, (B, P, 2)).astype(np.int32)
    index_p[:, 3] = index_v[:, 3] = 0
    index_p[1] = index_v[1] = 0
    index_p[0, 1:] = index_v[0, 1:] = 0
    ent = rng.integers(0, B, (B, P, 2)).astype(np.int32)
    val = rng.integers(0, P, (B, P, 2)).astype(np.int32)
    jm = jst.StructureAggregator(cfg, with_lpm=True)
    kw = dict(deterministic=True, neg_entity_idx=ent, neg_value_idx=val)
    p = redraw(jm.init(jax.random.PRNGKey(0), c0, seq, index_p, index_v, **kw)["params"], 5)
    tm = port_module(tst.StructureAggregator(torch_config(cfg), with_lpm=True), p,
                     "structure/", "")
    want = jm.apply({"params": p}, c0, seq, index_p, index_v, **kw)
    got = tm(torch.from_numpy(c0), torch.from_numpy(seq),
             torch.from_numpy(index_p).long(), torch.from_numpy(index_v).long(),
             neg_entity_idx=torch.from_numpy(ent), neg_value_idx=torch.from_numpy(val))
    close(got[0], want[0])
    close(got[1], want[1])
    assert float(want[1]) > 0


def test_sample_without_replacement_draws_distinct_valid_candidates():
    valid = torch.tensor([[True, False, True, True, False], [False] * 4 + [True]])
    idx, ok = tst.sample_without_replacement(torch.Generator().manual_seed(0),
                                             (2, 5), valid, 3)
    assert sorted(idx[0].tolist()) == [0, 2, 3] and ok[0].all()
    assert idx[1, 0] == 4 and ok[1].tolist() == [True, False, False]
