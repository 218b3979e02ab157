"""The port's `load_pretrained` decides as the JAX package's
`load_pretrained_into_params` (k3m_tpu/train/convert.py:316-363, with the
finetune CLI's allowed_unconsumed): on each planted checkpoint, loaded into
the same weights of a CE item-alignment model, the two raise alike, strict
and not, and where they load they set the same weights to the same values
(a model weight the checkpoint lacks keeps its value in both)."""

import re

import jax
import numpy as np
import pytest
import torch

from k3m_tpu.train.convert import _flatten, load_pretrained_into_params
from k3m_tpu_torch.convert import from_jax_params, load_pretrained
from k3m_tpu_torch.model.alignment import build_model
from k3m_tpu_torch.model.pretrain import build_pretraining_model
from tests.conftest import NANO
from tests.test_torch_finetune import jax_params_of, seeded_model
from tests.test_torch_modules import torch_config

CFG = torch_config(NANO.replace(loss_type="ce"))
ALLOWED = (r"cls\.seq_relationship\.",)


def _alignment_sd():
    sd = build_model(CFG, seed=21, device="cpu", train=True).state_dict()
    # an HF-style layout: the text stream under `bert.`
    return {("bert." + k if k.startswith(("embeddings.", "encoder.")) else k): v
            for k, v in sd.items()}


def _pretraining_sd(keep_mlm_heads):
    sd = build_pretraining_model(CFG, seed=22, device="cpu").state_dict()
    drop = re.compile(r"^cls\.(predictions|imagePredictions)\.")
    return {k: v for k, v in sd.items() if keep_mlm_heads or not drop.search(k)}


def _renamed(sd):
    sd["bert.embeddings.word_embedding.weight"] = sd.pop("bert.embeddings.word_embeddings.weight")


def _rogue(sd):
    sd["bert.encoder.layer.0.attention.self.query_v2.weight"] = torch.zeros(4, 4)


def _reshaped(sd):
    sd["bert.embeddings.word_embeddings.weight"] = torch.zeros(7, 3)


def _dead(sd):
    for k in ("t_pooler.dense.weight", "v_pooler.dense.weight", "bert.pooler.dense.bias",
              "bert.encoder.c_layer.0.biOutput.q_dense1.weight", "map_individual_to_bi.weight",
              "bi_seq_relationship.weight", "cls.predictions.decoder.weight",
              "bert.encoder.layer.0.output.LayerNorm.gamma"):
        sd[k] = torch.zeros(4, 4)
    sd["bert.embeddings.position_ids"] = torch.arange(16)


def _nsp_head(sd):
    sd["cls.seq_relationship.weight"] = torch.zeros(2, 7)      # sized for plain BERT
    sd["cls.seq_relationship.bias"] = torch.zeros(2)


CASES = {
    "faithful": (_alignment_sd, None, False),
    "renamed key": (_alignment_sd, _renamed, True),
    "rogue extra key": (_alignment_sd, _rogue, True),
    "shape mismatch": (_alignment_sd, _reshaped, True),
    "ignorable dead keys": (_alignment_sd, _dead, False),
    "HF cls.seq_relationship": (_alignment_sd, _nsp_head, False),
    "pretraining trunk into ce (no classifier)": (lambda: _pretraining_sd(False), None, False),
    "pretraining with its MLM heads into ce": (lambda: _pretraining_sd(True), None, True),
}


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_strict_load_decides_as_jax(tmp_path, case, strict):
    make, mutate, strict_raises = CASES[case]
    sd = make()
    if mutate:
        mutate(sd)
    path = str(tmp_path / "ckpt.bin")
    torch.save(sd, path)
    model = seeded_model(NANO.replace(loss_type="ce"), seed=5)   # no zero or one weights
    before = {k: v.clone() for k, v in model.state_dict().items()}
    params = jax_params_of(model)

    def jax_load():
        return load_pretrained_into_params(params, path, strict=strict,
                                           allowed_unconsumed=ALLOWED)

    if strict and strict_raises:
        with pytest.raises(ValueError, match="not consumed"):
            jax_load()
        with pytest.raises(ValueError, match="not consumed"):
            load_pretrained(model, path, strict=strict)
        return
    flat = {k: np.asarray(v) for k, v in _flatten(jax_load()["params"]).items()}
    want = from_jax_params(flat)
    loaded = load_pretrained(model, path, strict=strict)
    got = model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    # what the port reports as loaded is what changed from the seeded model,
    # and a weight the checkpoint lacks kept its value
    assert loaded == {k for k in got if not torch.equal(got[k], before[k])}
    if case.startswith("pretraining"):
        assert not any(k.startswith("classifier.") for k in loaded)
    assert jax.tree.leaves(params)       # the JAX side loaded into a real tree
