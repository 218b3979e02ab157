"""The rest of the port's checkpoint conversion (k3m_tpu_torch.convert)
against the JAX package's (k3m_tpu/train/convert.py), on the CPU, with the
same NANO pretraining weights (seeded numpy values in the JAX tree's shapes,
carried into the port by from_jax_params):

  * a TF1 checkpoint: load_tf_state_dict gives JAX's dict bit for bit, and
    load_pretrained sets the weights JAX's load_pretrained_into_params
    sets, bit for bit; require_complete raises where JAX's raises;
  * resize_word_embeddings grown and shrunk: the same rows, bit for bit;
  * `python -m k3m_tpu_torch.convert export`: the names and values of
    JAX's save_reference_checkpoint for both prefixes, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from k3m_tpu.model import pretrain as jpt
from k3m_tpu.train import convert as jconvert
from k3m_tpu_torch import convert
from k3m_tpu_torch.model import pretrain as tpt
from tests.conftest import NANO
from tests.test_torch_modules import torch_config
from tests.test_torch_pretrain_model import _model_inputs

CFG = NANO.replace(num_negative_pv=4)


@pytest.fixture(scope="module")
def params():
    """JAX's K3MForPretraining parameter tree at NANO (shapes from
    eval_shape), every leaf drawn from a seeded numpy generator."""
    batch, inject = _model_inputs(CFG)
    shapes = jax.eval_shape(
        lambda b, i: jpt.K3MForPretraining(CFG).init(
            {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1),
             "lpm": jax.random.PRNGKey(2)}, b, deterministic=True, **i), batch, inject)
    rng = np.random.default_rng(7)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                        {"params": shapes["params"]})


def _flat(tree):
    return {k: np.asarray(v) for k, v in jconvert._flatten(tree["params"]).items()}


def _port(params):
    model = tpt.K3MForPretraining(torch_config(CFG))
    model.load_state_dict(convert.from_jax_params(_flat(params)), strict=True)
    return model


def _assert_model_is(model, params):
    want = convert.from_jax_params(_flat(params))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _tf_name(name, value):
    """A reference torch name -> the TF1 BERT variable name and value
    (the inverse of load_tf_state_dict's mapping)."""
    parts = name.split(".")
    out = []
    for i, p in enumerate(parts[:-1]):
        if p.isdigit():
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    last, parent = parts[-1], out[-1]
    if parent in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        return "/".join(out), value
    if name == "cls.predictions.bias":
        return "cls/predictions/output_bias", value
    if parent == "LayerNorm":
        return "/".join(out + ["gamma" if last == "weight" else "beta"]), value
    if last == "weight":
        return "/".join(out + ["kernel"]), value.T
    return "/".join(out + [last]), value


def _tf_checkpoint(path, sd):
    """Write `sd` (reference torch names) as a TF1 checkpoint, with an Adam
    slot and global_step that the reader must skip; returns its prefix."""
    tf1 = pytest.importorskip("tensorflow").compat.v1
    g = tf1.Graph()
    with g.as_default():
        for name, value in sd.items():
            tf_name, arr = _tf_name(name, np.asarray(value))
            tf1.get_variable(tf_name, initializer=np.ascontiguousarray(arr))
        tf1.get_variable("bert/embeddings/word_embeddings/adam_m",
                         initializer=np.zeros((2, 2), np.float32))
        tf1.train.get_or_create_global_step()
        saver = tf1.train.Saver()
        with tf1.Session(graph=g) as sess:
            sess.run(tf1.global_variables_initializer())
            return saver.save(sess, str(path / "model.ckpt"))


@pytest.fixture(scope="module")
def tf_checkpoints(tmp_path_factory, params):
    """Two TF1 checkpoints of the same weights redrawn: the whole model
    under HF names (`bert.` trunk), and its text stream alone."""
    rng = np.random.default_rng(11)
    other = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), params)
    full = jconvert.flat_to_reference(_flat(other), bert_prefix="bert.")
    full.pop("cls.predictions.decoder.weight")        # the tied alias: not a TF variable
    text = {k: v for k, v in full.items()
            if k.startswith(("bert.embeddings.", "bert.encoder.layer."))}
    out = {}
    for name, sd in (("full", full), ("text", text)):
        d = tmp_path_factory.mktemp(f"tf_{name}")
        out[name] = _tf_checkpoint(d, sd)
    return out


def test_load_tf_state_dict_equals_jax(tf_checkpoints):
    for prefix in tf_checkpoints.values():
        assert convert.is_tf_checkpoint(prefix) and jconvert.is_tf_checkpoint(prefix)
        assert convert.is_tf_checkpoint(prefix + ".index")
        got, want = convert.load_tf_state_dict(prefix), jconvert.load_tf_state_dict(prefix)
        assert set(got) == set(want) and not any("adam" in k for k in got)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k
    assert not convert.is_tf_checkpoint(prefix + ".data")


@pytest.mark.parametrize("which", ["full", "text"])
@pytest.mark.parametrize("as_index", [False, True])
def test_load_pretrained_tf_sets_the_weights_jax_sets(params, tf_checkpoints, which,
                                                      as_index):
    """Strict loads of the whole model and of the text stream alone, by
    prefix and by its .index path: every weight of the port equals JAX's
    tree afterwards; with require_complete, the text-only checkpoint
    raises in both packages and the whole one passes in both."""
    path = tf_checkpoints[which] + (".index" if as_index else "")
    want = jconvert.load_pretrained_into_params(params, path, strict=True)
    model = _port(params)
    loaded = convert.load_pretrained(model, path, strict=True)
    _assert_model_is(model, want)
    assert len(loaded) > 0
    if which == "text":
        with pytest.raises(ValueError, match="uninitialized"):
            jconvert.load_pretrained_into_params(params, path, require_complete=True)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        fresh = _port(params)
        with pytest.raises(ValueError, match="uninitialized"):
            convert.load_pretrained(fresh, path, require_complete=True)
        _assert_model_is(fresh, params)           # raised before touching the model
        assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    else:
        jconvert.load_pretrained_into_params(params, path, require_complete=True)
        assert loaded == set(model.state_dict())
        convert.load_pretrained(_port(params), path, require_complete=True)


def test_require_complete_on_torch_files_raises_where_jax_does(tmp_path, params):
    """A reference .bin of the whole model passes require_complete in both
    packages; with one weight dropped it raises in both."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in jconvert.flat_to_reference(_flat(params)).items()}
    torch.save(sd, tmp_path / "full.bin")
    del sd["encoder.v_layer.0.output.dense.bias"]
    torch.save(sd, tmp_path / "less.bin")
    for name, raises in (("full.bin", False), ("less.bin", True)):
        path = str(tmp_path / name)
        model = _port(params)
        if raises:
            with pytest.raises(ValueError, match="uninitialized"):
                jconvert.load_pretrained_into_params(params, path, strict=True,
                                                     require_complete=True)
            with pytest.raises(ValueError, match="uninitialized"):
                convert.load_pretrained(model, path, strict=True, require_complete=True)
        else:
            want = jconvert.load_pretrained_into_params(params, path, strict=True,
                                                        require_complete=True)
            convert.load_pretrained(model, path, strict=True, require_complete=True)
            _assert_model_is(model, want)


@pytest.mark.parametrize("new_vocab", [CFG.vocab_size + 37, CFG.vocab_size - 50])
def test_resize_word_embeddings_equals_jax(params, new_vocab):
    """Grown (new rows drawn by default_rng(seed)) and shrunk: the word
    table and the MLM decoder bias bit for bit JAX's, every other weight
    untouched; the grown model still runs a forward (the batch's ids lie
    below the NANO vocabulary, so the shrunk one cannot take them)."""
    want = jconvert.resize_word_embeddings(params, new_vocab, seed=5)
    model = convert.resize_word_embeddings(_port(params), new_vocab, seed=5)
    _assert_model_is(model, want)
    assert model.embeddings.word_embeddings.weight.shape[0] == new_vocab
    assert model.embeddings.word_embeddings.num_embeddings == new_vocab
    if new_vocab < CFG.vocab_size:
        return
    batch, inject = _model_inputs(CFG)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    batch = {k: v if v.is_floating_point() else v.long() for k, v in batch.items()}
    inject = {k: ({m: torch.from_numpy(x) for m, x in v.items()} if isinstance(v, dict)
                  else torch.from_numpy(v).long()) for k, v in inject.items()}
    with torch.no_grad():
        out = model(batch, deterministic=True, **inject)
    assert all(torch.isfinite(v).all() for v in out.values() if torch.is_tensor(v))


@pytest.mark.parametrize("prefix,form", [("", "model"), ("bert.", "state")])
def test_export_cli_writes_jax_names_and_values(tmp_path, params, prefix, form):
    """`export --params` of the port's pytorch_model.bin (and of a full
    state.pt, read through its `model` entry) against JAX's
    save_reference_checkpoint of the same weights: the same names, the tied
    decoder alias among them, and the same fp32 values."""
    want_path, got_path = tmp_path / "jax.bin", tmp_path / "port.bin"
    n_want = jconvert.save_reference_checkpoint(params, str(want_path), bert_prefix=prefix)
    sd = _port(params).state_dict()
    src = tmp_path / "model_file.pt"
    torch.save(sd if form == "model" else dict(model=sd, optimizer={}, step=3), src)
    n_got = convert.main(["export", "--params", str(src), "--out", str(got_path),
                          "--bert_prefix", prefix])
    want = torch.load(want_path, weights_only=True)
    got = torch.load(got_path, weights_only=True)
    assert n_got == n_want == len(want)
    assert set(got) == set(want)
    assert "cls.predictions.decoder.weight" in got
    assert (prefix + "embeddings.word_embeddings.weight") in got
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32 and torch.equal(got[k], v), k
