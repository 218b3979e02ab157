"""The single-stream baseline (k3m_tpu_torch/model/basebert.py) against the
JAX package's (k3m_tpu/model/basebert.py), in fp32 on the CPU, with the
same weights (the JAX trees through from_jax_params, every leaf redrawn so
that biases and LayerNorm parameters are non-trivial) and the same numpy
inputs: SingleStreamModel's outputs, BaseBertForPretraining's three losses
and its score tensors, BaseBertForVLTasks' seven outputs. The JAX models
run eagerly. Tolerance 1e-4 relative / 1e-5 absolute (fp32, two layers
and the heads summed in another order).
"""

import jax
import numpy as np
import pytest
import torch

from k3m_tpu.model import basebert as jbb
from k3m_tpu.train.convert import _flatten
from k3m_tpu_torch.convert import from_jax_params
from k3m_tpu_torch.model import basebert as tbb
from tests.test_torch_modules import redraw, torch_config

TOL = dict(rtol=1e-4, atol=1e-5)
B, LT, LV = 2, 7, 5


@pytest.fixture(scope="module")
def cfg():
    # tests/test_basebert.py's geometry: single stream, v_hidden == hidden
    from k3m_tpu.config import K3MConfig
    return K3MConfig(
        vocab_size=120, hidden_size=24, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=48,
        v_feature_size=12, v_target_size=9, v_hidden_size=24,
        v_num_attention_heads=4, v_intermediate_size=48,
        bi_hidden_size=16, bi_num_attention_heads=4,
        v_biattention_id=(0,), t_biattention_id=(1,),
        max_position_embeddings=64)


@pytest.fixture(scope="module")
def inputs(cfg):
    rng = np.random.default_rng(0)
    x = dict(
        input_ids=rng.integers(1, cfg.vocab_size, (B, LT)).astype(np.int32),
        image_feat=rng.normal(size=(B, LV, cfg.v_feature_size)).astype(np.float32),
        image_loc=rng.normal(size=(B, LV, 5)).astype(np.float32),
        token_type_ids=rng.integers(0, 2, (B, LT)).astype(np.int32),
        attention_mask=np.array([[1] * LT, [1] * 5 + [0] * 2], np.int32),
        image_attention_mask=np.array([[1] * LV, [1] * 3 + [0] * 2], np.int32))
    tgt = rng.random((B, LV - 1, cfg.v_target_size)).astype(np.float32)
    tgt /= tgt.sum(-1, keepdims=True)
    tgt[0, 1, :3] = 0.0                   # zero soft labels: t log t's zero branch
    labels = dict(image_target=tgt,
                  masked_lm_labels=rng.choice([-1, 3, 7], (B, LT)).astype(np.int32),
                  image_label=np.array([[1, -1, 1, 1], [-1, 1, -1, 1]], np.int32),
                  next_sentence_label=np.array([0, 1], np.int32))
    return x, labels


def to_torch(d):
    return {k: torch.from_numpy(v) if v.dtype.kind == "f" else torch.from_numpy(v).long()
            for k, v in d.items()}


def ported(module, params, torch_prefix=""):
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    module.load_state_dict({k[len(torch_prefix):]: v for k, v in from_jax_params(flat).items()},
                           strict=True)
    return module.eval()


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_single_stream_model_matches_jax(cfg, inputs):
    """(sequence over text + image tokens, tanh pooler, word table)."""
    x, _ = inputs
    jm = jbb.SingleStreamModel(cfg)
    p = redraw(jm.init(jax.random.PRNGKey(0), **x)["params"], 1)
    want = jm.apply({"params": p}, **x)
    tm = ported(tbb.SingleStreamModel(torch_config(cfg)), {"bert": p}, "bert.")
    with torch.no_grad():
        got = tm(**to_torch(x))
    assert got[0].shape == (B, LT + LV, cfg.hidden_size)
    for g, w in zip(got, want):
        close(g, w)


def test_pretraining_losses_and_scores_match_jax(cfg, inputs):
    """The three losses (MLM, masked-image KLDiv with its t log t term,
    alignment), and the scores without labels; the decoder is tied to the
    word table, the image head untied to v_target_size classes."""
    x, labels = inputs
    jm = jbb.BaseBertForPretraining(cfg)
    jx = dict(x, **labels)
    p = redraw(jm.init(jax.random.PRNGKey(0), **jx)["params"], 2)
    want = jm.apply({"params": p}, **jx)
    tm = ported(tbb.BaseBertForPretraining(torch_config(cfg)), p)
    assert "cls.predictions.decoder.weight" not in tm.state_dict()
    assert tm.cls.imagePredictions.decoder.weight.shape == (cfg.v_target_size,
                                                           cfg.hidden_size)
    with torch.no_grad():
        got = tm(**to_torch(jx))
        scores = tm(**to_torch(dict(x, image_target=labels["image_target"])))
    for g, w in zip(got, want):
        assert float(w) > 0
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-4, atol=1e-6)
    jscores = jm.apply({"params": p}, **dict(x, image_target=labels["image_target"]))
    for g, w in zip(scores, jscores):
        close(g, w)


def test_vl_tasks_match_jax(cfg, inputs):
    """The seven outputs of the task-head bundle, the masked vision logits
    included."""
    x, _ = inputs
    jm = jbb.BaseBertForVLTasks(cfg, num_labels=11)
    p = redraw(jm.init(jax.random.PRNGKey(0), **x)["params"], 3)
    want = jm.apply({"params": p}, **x)
    tm = ported(tbb.BaseBertForVLTasks(torch_config(cfg), num_labels=11), p)
    with torch.no_grad():
        got = tm(**to_torch(x))
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        close(g, w)


def test_pretraining_trains_on_the_cpu(cfg, inputs):
    """A training forward (dropout from a StepRandom) and its backward give
    finite losses and a gradient on every parameter."""
    from k3m_tpu_torch.model.layers import init_weights
    from k3m_tpu_torch.model.random import StepRandom
    x, labels = inputs
    model = init_weights(tbb.BaseBertForPretraining(torch_config(cfg)), 0, 0.02)
    losses = model(**to_torch(dict(x, **labels)), deterministic=False,
                   rng=StepRandom(0, 0, "cpu"))
    sum(losses).backward()
    assert all(torch.isfinite(v) for v in losses)
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    assert missing == [], missing


def test_single_stream_needs_equal_widths(cfg):
    with pytest.raises(ValueError, match="v_hidden_size == hidden_size"):
        tbb.SingleStreamModel(torch_config(cfg.replace(v_hidden_size=16,
                                                       v_num_attention_heads=4)))
