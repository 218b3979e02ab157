"""One training step of the port's K3MForItemAlignment against
`jax.value_and_grad` of the JAX model on the CPU at NANO shapes
(deterministic=False, dropout 0, fusion strategies without draws), from the
same weights and the same numpy pair batch: the loss within 1e-5 relative,
each parameter's gradient within 1e-4 of that tensor's largest magnitude
plus 1e-7 (of its weight's, for the biases whose gradient is zero in exact
arithmetic). The helpers here (pair batches, seeded models, the inverse
weight bridge) serve the other finetune tests too.
"""

import re

import jax
import numpy as np
import pytest
import torch

from k3m_tpu.model.alignment import K3MForItemAlignment as JaxAlignment
from k3m_tpu.train.alignment_loop import device_item
from k3m_tpu.train.convert import _flatten
from k3m_tpu_torch.convert import _flax_to_torch, from_jax_params
from k3m_tpu_torch.model.alignment import build_model
from k3m_tpu_torch.model.random import StepRandom
from k3m_tpu_torch.train.alignment_loop import batch_to_device
from tests.conftest import NANO, make_pretrain_batch
from tests.test_torch_modules import torch_config

SOFTMAX_SHIFT = re.compile(r"(\.key[12]?\.bias|^struc_w2\.bias)$")
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  v_hidden_dropout_prob=0.0, v_attention_probs_dropout_prob=0.0)


def pair_batch(cfg, B=4, seed=0):
    """A NANO pair batch with ragged masks and labels 0, 1, 0, 1."""
    items = []
    for side in (1, 2):
        it = device_item(make_pretrain_batch(cfg, B=B, L=8, Lpv=12, R=4, P=3,
                                             seed=10 * seed + side))
        rng = np.random.default_rng(10 * seed + side + 100)
        for key, n in (("input_mask", 8), ("input_mask_pv", 12), ("image_mask", 5)):
            for b in range(1, B):
                it[key][b, n - rng.integers(1, n // 2):] = 0
        items.append(it)
    return dict(label=(np.arange(B) % 2).astype(np.float32), item1=items[0], item2=items[1])


def jax_params_of(model):
    """The flax parameter tree of a port model (fp32 numpy; Dense kernels
    transposed back), through the inverse of the weight bridge."""
    sd = model.state_dict()
    tree = {}
    for path, sym in _flax_to_torch().items():
        if sym.name not in sd:
            continue
        value = sd[sym.name].detach().float().numpy()
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(value.T if sym.transposed else value)
    return {"params": tree}


def seeded_model(cfg, seed=3):
    """A training port model whose weights are all non-trivial: Linear
    weights ~ N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.01), every other
    vector N(0, 0.01)."""
    model = build_model(torch_config(cfg), seed=seed, device="cpu", train=True)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 2:
                p.copy_(torch.randn(p.shape, generator=g) / p.shape[1] ** 0.5)
            else:
                base = 1.0 if re.search(r"LayerNorm\d?\.weight$", name) else 0.0
                p.copy_(base + 0.1 * torch.randn(p.shape, generator=g))
    return model


# --------------------------------------------------- one step against JAX

@pytest.mark.parametrize("strategy", [0, 2])
@pytest.mark.parametrize("loss_type", ["inner", "cosine", "ce"])
def test_train_step_loss_and_gradients_match_jax(loss_type, strategy):
    cfg = NANO.replace(loss_type=loss_type, if_pre_sampling=strategy, **NO_DROPOUT)
    batch = pair_batch(cfg)
    model = seeded_model(cfg)
    params = jax_params_of(model)
    jm = JaxAlignment(cfg)

    def loss_fn(p):
        return jm.apply(p, batch["label"], batch["item1"], batch["item2"],
                        deterministic=False, rngs={"dropout": jax.random.PRNGKey(1),
                                                   "gumbel": jax.random.PRNGKey(2)})[3]

    want, grads = jax.value_and_grad(loss_fn)(params)
    b = batch_to_device(batch, "cpu")
    _, _, _, loss = model(b["label"], b["item1"], b["item2"], deterministic=False,
                          rng=StepRandom(0, 0))
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want)), (loss.item(), want)
    loss.backward()
    flat = {k: np.asarray(v) for k, v in _flatten(grads["params"]).items()}
    want_grads = from_jax_params(flat)
    named = dict(model.named_parameters())
    assert set(want_grads) == set(named)
    for name, g in want_grads.items():
        # a bias that shifts a softmax's input has a gradient that is zero
        # in exact arithmetic; its scale is that of its weight's gradient
        scale = want_grads[name[:-len("bias")] + "weight"] if SOFTMAX_SHIFT.search(name) else g
        tol = 1e-4 * float(scale.abs().max()) + 1e-7
        got = named[name].grad
        got = torch.zeros_like(g) if got is None else got
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=0, atol=tol, err_msg=name)
