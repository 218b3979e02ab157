"""Attention maps (`config.visualization`, k3m_tpu_torch/model/visualize.py)
against the JAX package's `forward_with_attention`, in fp32 on the CPU, on
the NANO pretraining model with the same weights, batch and injected draws
(tests/test_torch_pretrain_model.py). The JAX model is applied once,
eagerly, as that file applies it.

Tolerance 1e-5 on each map (fp32 softmax of the same scores); the loss
outputs with the maps on equal those with them off (kernels' plain
versions against the unfused torch ops) within 1e-5 relative.
"""

import re

import numpy as np
import pytest
import torch

from k3m_tpu.model.visualize import flatten_attention as jax_flatten
from k3m_tpu_torch.config import K3MConfig as TorchConfig
from k3m_tpu_torch.model import visualize
from k3m_tpu_torch.model.visualize import flatten_attention, forward_with_attention
from tests.conftest import NANO
from tests.test_torch_pretrain_model import (
    LOSSES, _model_inputs, _to_torch, jax_pretraining, port_pretraining,
)

CFG = NANO.replace(visualization=True, num_negative_pv=4)


def port_path(jax_key: str) -> str:
    """A JAX intermediates key (`trunk/encoder/layer_0/attention/
    attention_probs/1`) as the port's (`encoder.layer.0.attention.self/
    attention_probs/1`)."""
    parts = jax_key.split("/")[1:]                    # drop `trunk`
    i = next(n for n, p in enumerate(parts) if p in ("attention_probs", "attn1", "attn2"))
    mods = [re.sub(r"^(.*)_(\d+)$", r"\1.\2", p) for p in parts[:i]]
    if mods[-1] == "attention":
        mods.append("self")
    return "/".join([".".join(mods)] + parts[i:])


@pytest.fixture(scope="module")
def maps():
    batch, inject = _model_inputs(CFG)
    jm, params = jax_pretraining(CFG, batch, inject)
    jout, inter = jm.apply(params, batch, deterministic=True, mutable=["intermediates"],
                           **inject)
    model = port_pretraining(CFG, params)
    tb, ti = _to_torch(batch), _to_torch(inject)
    with torch.no_grad():
        out, got = forward_with_attention(model, tb, deterministic=True, **ti)
        off = port_pretraining(CFG.replace(visualization=False), params)
        base = off(tb, deterministic=True, **ti)
    return dict(jax=jax_flatten(inter["intermediates"]), jout=jout, port=got,
                flat=flatten_attention(got), out=out, base=base, off=off, tb=tb, ti=ti)


def test_maps_equal_the_jax_maps_site_by_site(maps):
    """Every JAX site has its port site, with the same count of maps (one
    per invocation, pass order) and the same [B, H, Lq, Lk] probabilities
    within 1e-5; both co-attention directions are there as attn1/attn2."""
    want = {port_path(k): np.asarray(v) for k, v in maps["jax"].items()}
    got = maps["flat"]
    assert set(got) == set(want) and len(got) > 10
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-5, atol=1e-5, err_msg=key)
    assert any(k.endswith("/attn1") or "/attn1/" in k for k in got)
    assert any(k.endswith("/attn2") or "/attn2/" in k for k in got)
    counts = {p: {n: len(v) for n, v in sites.items()} for p, sites in maps["port"].items()}
    assert counts["encoder.layer.0.attention.self"] == {"attention_probs": 4}
    assert counts["encoder.c_layer.0.biattention"] == {"attn1": 1, "attn2": 1}


def test_maps_are_probabilities_and_leave_the_losses(maps):
    """Each map's rows sum to 1 (within the JAX test's 2e-2; here fp32) and
    the losses with the maps on equal those of the kernel path (their
    plain versions here) with them off."""
    for key, v in maps["flat"].items():
        assert v.dim() == 4, key
        np.testing.assert_allclose(v.sum(-1).numpy(), 1.0, atol=2e-2, err_msg=key)
    for k in LOSSES:
        np.testing.assert_allclose(maps["out"][k].item(), maps["base"][k].item(), rtol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(maps["out"][k].item(), float(maps["jout"][k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_visualization_off_collects_nothing(maps):
    """With visualization off no site records a map, and
    forward_with_attention refuses the model."""
    with torch.no_grad(), visualize.collecting(maps["off"]) as got:
        maps["off"](maps["tb"], deterministic=True, **maps["ti"])
    assert got == {}
    with pytest.raises(ValueError, match="visualization"):
        forward_with_attention(maps["off"], maps["tb"], deterministic=True)


def test_visualization_refuses_use_pallas():
    """As the JAX config: the fused kernels never form the probabilities."""
    with pytest.raises(ValueError, match="visualization"):
        TorchConfig(visualization=True, use_pallas=True)
