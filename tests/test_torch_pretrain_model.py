"""The port's K3MForPretraining against the JAX package's, in fp32 on the
CPU, with the same weights (carried by from_jax_params) and the same numpy
batch: the loss dict and every parameter's gradient, the weight bridge of
the pretraining heads, and the optimizer's decay mask.

Dropout is off (deterministic) and the draws the model would make (LPM
negatives, Gumbel noise) are injected into both packages. Tolerances: 1e-4
relative on the losses and, per gradient tensor, 1e-4 of that tensor's
largest magnitude plus 1e-7 (a few dozen layers of fp32 sums in another
order, and the LayerNorm backward that rebuilds xhat from the saved
output).
"""

import jax
import numpy as np
import pytest
import torch

from k3m_tpu.model import pretrain as jpt
from k3m_tpu.train.convert import _flatten, flat_to_reference
from k3m_tpu.train.optim import is_no_decay as jax_is_no_decay
from k3m_tpu_torch.convert import _flax_to_torch, from_jax_params
from k3m_tpu_torch.model import pretrain as tpt
from k3m_tpu_torch.train.optim import is_no_decay, param_groups
from tests.conftest import NANO, make_nano_batch
from tests.test_torch_modules import redraw, torch_config


# ------------------------------------------------------------ the model

def _model_inputs(cfg, B=4, seed=0):
    """A NANO batch with ragged masks, injected negatives and Gumbel noise
    whose option gaps (>= 1) keep the hard selection away from ties."""
    batch = make_nano_batch(B=B, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for key, n in (("input_mask", 8), ("input_mask_pv", 12), ("image_mask", 5)):
        for b in range(1, B):
            batch[key][b, n - rng.integers(1, n // 2):] = 0
    batch["is_next"][0] = 1
    P = batch["index_p"].shape[1]
    n_ent = cfg.num_negative_pv // 2
    inject = dict(
        neg_entity_idx=rng.integers(0, B, (B, P, n_ent)).astype(np.int32),
        neg_value_idx=rng.integers(0, P, (B, P, cfg.num_negative_pv - n_ent)).astype(np.int32),
        gumbel_noise={m: (4.0 * np.eye(3)[rng.integers(0, 3, (B, n, s))].transpose(0, 1, 3, 2)
                          + 0.1 * rng.standard_normal((B, n, 3, s))).astype(np.float32)
                      for m, n, s in (("v", 5, cfg.bi_hidden_size), ("t", 8, cfg.hidden_size),
                                      ("pv", 12, cfg.hidden_size))})
    return batch, inject


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    t = torch.from_numpy(np.ascontiguousarray(tree))
    return t if t.is_floating_point() else t.long()


def jax_pretraining(cfg, batch, inject):
    jm = jpt.K3MForPretraining(cfg)
    params = jm.init({"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1),
                      "lpm": jax.random.PRNGKey(2)}, batch, deterministic=True, **inject)
    return jm, {"params": redraw(params["params"], 9)}


def port_pretraining(cfg, params):
    model = tpt.K3MForPretraining(torch_config(cfg))
    flat = {k: np.asarray(v) for k, v in _flatten(params["params"]).items()}
    model.load_state_dict(from_jax_params(flat), strict=True)
    return model


LOSSES = ("masked_lm_loss", "masked_img_loss", "masked_lm_loss_pv",
          "next_sentence_loss_t_v_pv", "loss_struc")


@pytest.mark.parametrize("strategy", [1, 2])
def test_pretraining_losses_and_gradients_match_jax(strategy):
    cfg = NANO.replace(if_pre_sampling=strategy, num_negative_pv=4)
    batch, inject = _model_inputs(cfg)
    jm, params = jax_pretraining(cfg, batch, inject)

    def loss_fn(p):
        out = jm.apply(p, batch, deterministic=True, **inject)
        total = sum(out[k] for k in ("masked_lm_loss", "masked_img_loss",
                                     "masked_lm_loss_pv", "loss_struc"))
        return total + out["next_sentence_loss_t_v_pv"], out

    (_, want), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = port_pretraining(cfg, params)
    got = model(_to_torch(batch), deterministic=True, **_to_torch(inject))
    for k in LOSSES:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
        assert float(want[k]) != 0.0, k
    sum(got[k] for k in LOSSES).backward()
    flat = {k: np.asarray(v) for k, v in _flatten(grads["params"]).items()}
    want_grads = from_jax_params(flat)
    named = dict(model.named_parameters())
    assert set(want_grads) == set(named)
    for name, g in want_grads.items():
        p = named[name]
        # a floor of 1e-7 for gradients that are zero in exact arithmetic
        # (struc_w2's bias: the softmax over pairs ignores a shift)
        tol = 1e-4 * float(g.abs().max()) + 1e-7
        got_g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(got_g.numpy(), g.numpy(), rtol=0, atol=tol, err_msg=name)


def test_weight_bridge_covers_the_pretraining_heads():
    """from_jax_params maps every parameter of the JAX pretraining model,
    the heads included, to flat_to_reference's names; the reference's
    tied decoder alias is the one name the port's model has no weight
    for."""
    batch, inject = _model_inputs(NANO)
    _, params = jax_pretraining(NANO, batch, inject)
    flat = {k: np.asarray(v) for k, v in _flatten(params["params"]).items()}
    mine, theirs = from_jax_params(flat), flat_to_reference(flat)
    assert set(theirs) - set(mine) == {"cls.predictions.decoder.weight"}
    for k, v in mine.items():
        np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)
    for part in ("cls.predictions.transform.dense.weight", "cls.predictions.bias",
                 "cls.imagePredictions.decoder.weight", "cls.seq_relationship.weight"):
        assert part in mine


def test_decay_mask_matches_jax():
    """The decay groups over the port's names equal the JAX mask carried
    through the name map."""
    batch, inject = _model_inputs(NANO)
    _, params = jax_pretraining(NANO, batch, inject)
    table = _flax_to_torch()
    jax_mask = {table[p].name: not jax_is_no_decay(tuple(p.split("/")))
                for p in _flatten(params["params"])}
    model = tpt.K3MForPretraining(torch_config(NANO))
    port_mask = {n: not is_no_decay(n) for n, _ in model.named_parameters()}
    assert port_mask == jax_mask
    groups = param_groups(model.named_parameters(), 1e-3, 0.01, {"cls.predictions.bias"})
    by_id = {id(p): g for g in groups for p in g["params"]}
    named = dict(model.named_parameters())
    assert by_id[id(named["cls.predictions.bias"])]["lr"] == pytest.approx(1e-4)
    assert by_id[id(named["cls.predictions.bias"])]["weight_decay"] == 0.0
    assert by_id[id(named["embeddings.word_embeddings.weight"])]["weight_decay"] == 0.01


def test_task_specific_tokens_are_refused():
    with pytest.raises(NotImplementedError, match="task_specific_tokens"):
        tpt.K3MForPretraining(torch_config(NANO).replace(task_specific_tokens=True))
