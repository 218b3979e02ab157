"""Weight bridge into the port.

  * `from_jax_params(flat)`: '/'-joined flax parameter paths of the JAX
    package (e.g. `trunk/encoder/layer_0/attention/query/kernel`) -> the
    port's state-dict names (`encoder.layer.0.attention.self.query.weight`),
    with Dense kernels transposed to torch's [out, in]; the single-stream
    baseline's tree (`bert/...`, model/basebert.py) too.
  * `load_pretrained(model, path, strict=..., require_complete=...)`: a
    reference or HF checkpoint (a torch file or a TF1 checkpoint,
    `load_tf_state_dict`) into a model, with the JAX package's strict-load
    decision; `load_pretrained_bert_paths(path)`: the weights such a torch
    checkpoint starts, which train at 0.1x the LR;
  * `resize_word_embeddings(model, n)`: the tied word table and the MLM
    decoder bias grown or shrunk, new rows drawn as the JAX package draws
    them;
  * `save_reference_checkpoint(model, path, bert_prefix)` and
    `python -m k3m_tpu_torch.convert export`: the port's weights under the
    reference's torch names, as the JAX package's export writes them;
  * `load_model_file(model, path)`: a model file the port wrote (a
    checkpoint's `pytorch_model.bin`, or the `model` entry of its
    `state.pt`) into a model, deciding as the JAX package's
    `load_params_msgpack`.
  * `from_jax_vision_params(tree)`: the JAX package's Faster R-CNN
    parameter tree (or any subtree of it: a Bottleneck, a stage) -> the
    port's state dict in detectron2's names.

The port's module names are the reference torch names, so the mapping
table is the JAX package's reference_to_flat (k3m_tpu/train/convert.py:
127-230), of which this module keeps its own copy.
"""

from __future__ import annotations

import argparse
import functools
import logging
import os
import re
from typing import Dict, Set, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


class _Sym:
    """Stand-in for a weight: its torch name and whether the mapping
    transposed it."""
    __slots__ = ("name", "transposed")

    def __init__(self, name: str, transposed: bool = False):
        self.name = name
        self.transposed = transposed

    @property
    def T(self) -> "_Sym":
        return _Sym(self.name, not self.transposed)


def _strip_prefix(name: str) -> str:
    for p in ("bert.", "roberta.", "model."):
        if name.startswith(p):
            return name[len(p):]
    return name


def _linear(dst, flax_path, sd, torch_name):
    w, b = torch_name + ".weight", torch_name + ".bias"
    if w in sd:
        dst[flax_path + "/kernel"] = sd[w].T
        if b in sd:
            dst[flax_path + "/bias"] = sd[b]


def _layernorm(dst, flax_path, sd, torch_name):
    w = torch_name + ".weight"
    if w in sd:
        dst[flax_path + "/scale"] = sd[w]
        dst[flax_path + "/bias"] = sd[torch_name + ".bias"]


def reference_to_flat(sd: Dict, trunk: str = "trunk") -> Dict:
    """Reference torch state dict -> '/'-joined flax paths (a copy of the
    JAX package's table)."""
    sd = {_strip_prefix(k): v for k, v in sd.items()}
    out: Dict = {}
    if "embeddings.word_embeddings.weight" in sd:
        out[f"{trunk}/word_embeddings"] = sd["embeddings.word_embeddings.weight"]
    for tname, fname in (("embeddings.position_embeddings.weight",
                          f"{trunk}/embeddings/position_embeddings"),
                         ("embeddings.token_type_embeddings.weight",
                          f"{trunk}/embeddings/token_type_embeddings"),
                         ("embeddings.task_embeddings.weight",
                          f"{trunk}/embeddings/task_embeddings")):
        if tname in sd:
            out[fname] = sd[tname]
    _layernorm(out, f"{trunk}/embeddings/LayerNorm", sd, "embeddings.LayerNorm")
    _linear(out, f"{trunk}/v_embeddings/image_embeddings", sd,
            "v_embeddings.image_embeddings")
    _linear(out, f"{trunk}/v_embeddings/image_location_embeddings", sd,
            "v_embeddings.image_location_embeddings")
    _layernorm(out, f"{trunk}/v_embeddings/LayerNorm", sd, "v_embeddings.LayerNorm")

    for stack, projs in (("layer", ("query", "key", "value")),
                         ("v_layer", ("query", "key", "value"))):
        i = 0
        while f"encoder.{stack}.{i}.attention.self.query.weight" in sd:
            t, f = f"encoder.{stack}.{i}", f"{trunk}/encoder/{stack}_{i}"
            for proj in projs:
                _linear(out, f"{f}/attention/{proj}", sd, f"{t}.attention.self.{proj}")
            if stack == "v_layer":
                for proj in ("dyLinear_q", "dyLinear_k"):
                    _linear(out, f"{f}/{proj}", sd, f"{t}.attention.self.{proj}")
            _linear(out, f"{f}/attention_output", sd, f"{t}.attention.output.dense")
            _layernorm(out, f"{f}/attention_LayerNorm", sd,
                       f"{t}.attention.output.LayerNorm")
            _linear(out, f"{f}/intermediate", sd, f"{t}.intermediate.dense")
            _linear(out, f"{f}/output", sd, f"{t}.output.dense")
            _layernorm(out, f"{f}/output_LayerNorm", sd, f"{t}.output.LayerNorm")
            i += 1

    for stack in ("c_layer", "c_layer_pv_v", "c_layer_pv_t"):
        i = 0
        while f"encoder.{stack}.{i}.biattention.query1.weight" in sd:
            t, f = f"encoder.{stack}.{i}", f"{trunk}/encoder/{stack}_{i}"
            for proj in ("query1", "key1", "value1", "query2", "key2", "value2"):
                _linear(out, f"{f}/biattention/{proj}", sd, f"{t}.biattention.{proj}")
            _linear(out, f"{f}/bi_dense1", sd, f"{t}.biOutput.dense1")
            _layernorm(out, f"{f}/bi_LayerNorm1", sd, f"{t}.biOutput.LayerNorm1")
            _linear(out, f"{f}/bi_dense2", sd, f"{t}.biOutput.dense2")
            _layernorm(out, f"{f}/bi_LayerNorm2", sd, f"{t}.biOutput.LayerNorm2")
            _linear(out, f"{f}/v_intermediate", sd, f"{t}.v_intermediate.dense")
            _linear(out, f"{f}/v_output", sd, f"{t}.v_output.dense")
            _layernorm(out, f"{f}/v_output_LayerNorm", sd, f"{t}.v_output.LayerNorm")
            _linear(out, f"{f}/t_intermediate", sd, f"{t}.t_intermediate.dense")
            _linear(out, f"{f}/t_output", sd, f"{t}.t_output.dense")
            _layernorm(out, f"{f}/t_output_LayerNorm", sd, f"{t}.t_output.LayerNorm")
            i += 1

    for mod in ("v", "t", "pv"):
        for score in ("score_self", "score_cross1", "score_cross2", "soft"):
            _linear(out, f"{trunk}/fusion/fusion_{mod}/{score}_{mod}", sd,
                    f"{score}_{mod}")
    _linear(out, f"{trunk}/fusion/map_bi_to_individual", sd, "map_bi_to_individual")
    for w in ("struc_w1", "struc_w2", "struc_w3"):
        _linear(out, f"structure/{w}", sd, w)

    _linear(out, "cls/predictions/transform_dense", sd, "cls.predictions.transform.dense")
    _layernorm(out, "cls/predictions/transform_LayerNorm", sd,
               "cls.predictions.transform.LayerNorm")
    if "cls.predictions.bias" in sd:
        out["cls/predictions/decoder_bias"] = sd["cls.predictions.bias"]
    _linear(out, "cls/seq_relationship", sd, "cls.seq_relationship")
    _linear(out, "cls/imagePredictions/transform_dense", sd,
            "cls.imagePredictions.transform.dense")
    _layernorm(out, "cls/imagePredictions/transform_LayerNorm", sd,
               "cls.imagePredictions.transform.LayerNorm")
    _linear(out, "cls/imagePredictions/decoder", sd, "cls.imagePredictions.decoder")

    _linear(out, "classifier/dense", sd, "classifier.dense")
    _linear(out, "classifier/out_proj", sd, "classifier.out_proj")
    return out


def _torch_name_universe(max_layers: int = 48):
    """Every torch name reference_to_flat consumes, with generous layer
    bounds."""
    lin = lambda base: [base + ".weight", base + ".bias"]
    U = ["embeddings.word_embeddings.weight", "embeddings.position_embeddings.weight",
         "embeddings.token_type_embeddings.weight", "embeddings.task_embeddings.weight"]
    U += lin("embeddings.LayerNorm") + lin("v_embeddings.image_embeddings")
    U += lin("v_embeddings.image_location_embeddings") + lin("v_embeddings.LayerNorm")
    for i in range(max_layers):
        for stack, projs in ((f"encoder.layer.{i}", ("query", "key", "value")),
                             (f"encoder.v_layer.{i}",
                              ("query", "key", "value", "dyLinear_q", "dyLinear_k"))):
            for p in projs:
                U += lin(f"{stack}.attention.self.{p}")
            for part in ("attention.output.dense", "attention.output.LayerNorm",
                         "intermediate.dense", "output.dense", "output.LayerNorm"):
                U += lin(f"{stack}.{part}")
        for stack in ("c_layer", "c_layer_pv_v", "c_layer_pv_t"):
            t = f"encoder.{stack}.{i}"
            for p in ("query1", "key1", "value1", "query2", "key2", "value2"):
                U += lin(f"{t}.biattention.{p}")
            for part in ("biOutput.dense1", "biOutput.LayerNorm1", "biOutput.dense2",
                         "biOutput.LayerNorm2", "v_intermediate.dense", "v_output.dense",
                         "v_output.LayerNorm", "t_intermediate.dense", "t_output.dense",
                         "t_output.LayerNorm"):
                U += lin(f"{t}.{part}")
    for mod in ("v", "t", "pv"):
        for score in ("score_self", "score_cross1", "score_cross2", "soft"):
            U += lin(f"{score}_{mod}")
    U += lin("map_bi_to_individual")
    for w in ("struc_w1", "struc_w2", "struc_w3"):
        U += lin(w)
    for part in ("cls.predictions.transform.dense", "cls.predictions.transform.LayerNorm",
                 "cls.seq_relationship", "cls.imagePredictions.transform.dense",
                 "cls.imagePredictions.transform.LayerNorm", "cls.imagePredictions.decoder",
                 "classifier.dense", "classifier.out_proj"):
        U += lin(part)
    return U + ["cls.predictions.bias"]


def _text_layer(dst, f, sd, t):
    """One TextLayer's weights: torch prefix `t`, flax prefix `f`."""
    for proj in ("query", "key", "value"):
        _linear(dst, f"{f}/attention/{proj}", sd, f"{t}.attention.self.{proj}")
    _linear(dst, f"{f}/attention_output", sd, f"{t}.attention.output.dense")
    _layernorm(dst, f"{f}/attention_LayerNorm", sd, f"{t}.attention.output.LayerNorm")
    _linear(dst, f"{f}/intermediate", sd, f"{t}.intermediate.dense")
    _linear(dst, f"{f}/output", sd, f"{t}.output.dense")
    _layernorm(dst, f"{f}/output_LayerNorm", sd, f"{t}.output.LayerNorm")


def basebert_to_flat(sd: Dict, max_layers: int = 48) -> Dict:
    """The single-stream baseline's torch names (model/basebert.py, the
    reference basebert's modules) -> the JAX package's flax paths
    (k3m_tpu/model/basebert.py)."""
    out: Dict = {}
    for tname, fname in (("bert.embeddings.word_embeddings.weight", "bert/word_embeddings"),
                         ("bert.embeddings.position_embeddings.weight",
                          "bert/embeddings/position_embeddings"),
                         ("bert.embeddings.token_type_embeddings.weight",
                          "bert/embeddings/token_type_embeddings"),
                         ("bert.v_embeddings.token_type_embeddings.weight",
                          "bert/image_embeddings/token_type_embeddings"),
                         ("cls.predictions.bias", "cls/predictions_bias")):
        if tname in sd:
            out[fname] = sd[tname]
    _layernorm(out, "bert/embeddings/LayerNorm", sd, "bert.embeddings.LayerNorm")
    for proj in ("image_embeddings", "image_location_embeddings"):
        _linear(out, f"bert/image_embeddings/{proj}", sd, f"bert.v_embeddings.{proj}")
    _layernorm(out, "bert/image_embeddings/LayerNorm", sd, "bert.v_embeddings.LayerNorm")
    for i in range(max_layers):
        _text_layer(out, f"bert/layer_{i}", sd, f"bert.encoder.layer.{i}")
    _linear(out, "bert/pooler", sd, "bert.pooler.dense")
    for head, flax_head in (("predictions", "predictions_transform"),
                            ("imagePredictions", "image_predictions_transform")):
        _linear(out, f"cls/{flax_head}/dense", sd, f"cls.{head}.transform.dense")
        _layernorm(out, f"cls/{flax_head}/LayerNorm", sd, f"cls.{head}.transform.LayerNorm")
    _linear(out, "cls/image_decoder", sd, "cls.imagePredictions.decoder")
    _linear(out, "cls/seq_relationship", sd, "cls.seq_relationship")
    _linear(out, "vil_prediction/fc1", sd, "vil_prediction.main.0")
    _linear(out, "vil_prediction/fc2", sd, "vil_prediction.main.3")
    for head in ("vil_logit", "vision_logit", "linguistic_logit"):
        _linear(out, head, sd, head)
    return out


def _basebert_name_universe(max_layers: int = 48):
    lin = lambda base: [base + ".weight", base + ".bias"]
    U = ["bert.embeddings.word_embeddings.weight", "bert.embeddings.position_embeddings.weight",
         "bert.embeddings.token_type_embeddings.weight",
         "bert.v_embeddings.token_type_embeddings.weight", "cls.predictions.bias"]
    U += lin("bert.embeddings.LayerNorm") + lin("bert.v_embeddings.image_embeddings")
    U += lin("bert.v_embeddings.image_location_embeddings") + lin("bert.v_embeddings.LayerNorm")
    for i in range(max_layers):
        t = f"bert.encoder.layer.{i}"
        for part in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense", "attention.output.LayerNorm",
                     "intermediate.dense", "output.dense", "output.LayerNorm"):
            U += lin(f"{t}.{part}")
    for part in ("bert.pooler.dense", "cls.predictions.transform.dense",
                 "cls.predictions.transform.LayerNorm", "cls.imagePredictions.transform.dense",
                 "cls.imagePredictions.transform.LayerNorm", "cls.imagePredictions.decoder",
                 "cls.seq_relationship", "vil_prediction.main.0", "vil_prediction.main.3",
                 "vil_logit", "vision_logit", "linguistic_logit"):
        U += lin(part)
    return U


@functools.cache
def _flax_to_torch():
    """flax path -> _Sym(torch name), by running the table over names."""
    return reference_to_flat({n: _Sym(n) for n in _torch_name_universe()})


@functools.cache
def _basebert_flax_to_torch():
    """The same for the single-stream baseline's tree."""
    return basebert_to_flat({n: _Sym(n) for n in _basebert_name_universe()})


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """'/'-joined flax paths -> the port's state-dict names, fp32 tensors,
    Dense kernels transposed: the K3M models' tree, or the single-stream
    baseline's (`bert/...`). A leading `params/` is ignored. Raises on a
    path the tables do not know."""
    table, basebert = _flax_to_torch(), _basebert_flax_to_torch()
    out: Dict[str, torch.Tensor] = {}
    unknown = []
    for path, value in flat.items():
        if path.startswith("params/"):
            path = path[len("params/"):]
        sym = table.get(path) or basebert.get(path)
        if sym is None:
            unknown.append(path)
            continue
        arr = np.asarray(value, np.float32)
        if sym.transposed:
            arr = arr.T
        out[sym.name] = torch.from_numpy(np.ascontiguousarray(arr))
    if unknown:
        raise KeyError(f"from_jax_params: no torch name for {sorted(unknown)[:8]}")
    return out


# flax module name of k3m_tpu/vision -> the port's (detectron2's) name
_VISION_NAMES = {"stem_conv1": "stem.conv1", "stem_bn1": "stem.conv1.norm",
                 "rpn": "proposal_generator.rpn_head",
                 "objectness": "objectness_logits", "roi_head": "roi_heads",
                 "box_predictor": "roi_heads.box_predictor",
                 "kernel": "weight"}


def from_jax_vision_params(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's vision parameter tree (`model.init(...)` of
    k3m_tpu.vision.frcnn.FasterRCNN, with or without its `params` level, or
    the tree of one of its submodules) -> the port's state dict: `blockN`
    becomes `N`, `<conv>_bn` the conv's `.norm`; a conv kernel
    [kh, kw, in, out] becomes [out, in, kh, kw], a dense kernel [in, out]
    becomes [out, in]; FrozenBN scale and bias keep their names."""
    tree = tree.get("params", tree)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if not hasattr(node, "items"):
            arr = np.asarray(node, np.float32)
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            names = []
            for part in path:
                if part.startswith("block") and part[5:].isdigit():
                    part = part[5:]
                elif part.endswith("_bn") and part != "stem_bn1":
                    part = part[:-3] + ".norm"
                names.append(_VISION_NAMES.get(part, part))
            out[".".join(names)] = torch.from_numpy(np.array(arr, order="C"))
            return
        for key, child in node.items():
            walk(child, path + (key,))

    walk(tree, ())
    return out


# Source keys a strict load may leave unconsumed, a copy of the JAX
# package's _IGNORABLE_SOURCE_RE (k3m_tpu/train/convert.py:281-295): dead
# reference parameters (poolers, q_dense*, map_individual_to_bi, the twin
# NSP head), loss buffers, HF bookkeeping, the tied MLM-decoder alias and
# pre-2019 HF LayerNorm names.
_IGNORABLE_SOURCE_RE = re.compile("|".join((
    r"(^|\.)t_pooler\.", r"(^|\.)v_pooler\.", r"(^|\.)pooler\.", r"q_dense\d",
    r"map_individual_to_bi", r"bi_seq_relationship", r"vis_criterion",
    r"(^|\.)position_ids$", r"cls\.predictions\.decoder\.weight$",
    r"cls\.seq_relationship_", r"(^|\.)LayerNorm\.gamma$", r"(^|\.)LayerNorm\.beta$",
)))


def _is_full_state(sd) -> bool:
    """A trainer's full state (Trainer.state_dict: model, optimizer,
    scheduler, step, micro)."""
    return isinstance(sd, dict) and "model" in sd and "optimizer" in sd


def load_tf_state_dict(ckpt_path: str) -> Dict[str, np.ndarray]:
    """A TF1-style BERT checkpoint as a torch-layout state dict that
    reference_to_flat reads: a copy of the JAX package's load_tf_state_dict
    (k3m_tpu/train/convert.py:43-89; reference `load_tf_weights_in_bert`,
    vilbert_k3m/vilbert_k3m.py:56-116). Names: `/` -> `.`, `layer_N` ->
    `layer.N`, `kernel` -> `weight` (transposed to torch [out, in]),
    `gamma`/`beta` -> `weight`/`bias`, `output_bias`/`output_weights` ->
    `bias`/`weight`, a trailing `*_embeddings` table gains `.weight`;
    optimizer slots (adam_v/adam_m) and `global_step` are skipped.
    tensorflow is imported here, at the call, as the JAX package does."""
    import tensorflow as tf

    reader = tf.train.load_checkpoint(ckpt_path)
    sd: Dict[str, np.ndarray] = {}
    for name, _ in tf.train.list_variables(ckpt_path):
        parts = name.split("/")
        if any(p in ("adam_v", "adam_m", "AdamWeightDecayOptimizer",
                     "AdamWeightDecayOptimizer_1", "global_step") for p in parts):
            continue
        arr = np.asarray(reader.get_tensor(name))
        mapped, transpose = [], False
        for p in parts:
            m = re.fullmatch(r"([A-Za-z_]+)_(\d+)", p)
            if m and m.group(1) in ("layer", "v_layer", "c_layer", "c_layer_pv_v",
                                    "c_layer_pv_t"):
                mapped.extend([m.group(1), m.group(2)])
                continue
            if p == "kernel":
                transpose = True
                mapped.append("weight")
            elif p in ("gamma", "output_weights"):
                mapped.append("weight")
            elif p in ("beta", "output_bias"):
                mapped.append("bias")
            else:
                mapped.append(p)
        if parts[-1].endswith("_embeddings"):
            mapped.append("weight")
        if transpose and arr.ndim == 2:
            arr = arr.T
        sd[".".join(mapped)] = arr
    return sd


def is_tf_checkpoint(path: str) -> bool:
    """True for a TF checkpoint prefix (`<path>.index` exists) or an
    `.index` path (k3m_tpu/train/convert.py:92-98)."""
    return path.endswith(".index") or os.path.exists(path + ".index")


def _read_reference(path: str) -> Dict[str, torch.Tensor]:
    """A reference or HF torch checkpoint's tensors by name (`module.` and
    a `model_state_dict` wrapper removed). A trainer's full state is
    refused by name: its weights are under `model`, which no reference
    name maps, so reading it as a reference checkpoint would set nothing."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if _is_full_state(sd):
        raise ValueError(
            f"{path} is a trainer's full state (keys {sorted(sd)[:6]}), not a reference "
            f"checkpoint: load its model with --file_state_dict (convert.load_model_file)")
    if isinstance(sd, dict) and "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}


def load_pretrained_bert_paths(path: str) -> Set[str]:
    """The port's names of every weight a reference checkpoint maps, the
    0.1x-LR set: a copy of the JAX package's load_pretrained_bert_paths
    (k3m_tpu/train/convert.py:366-370, ref train_concap_struc.py:372-373),
    which takes every source name reference_to_flat maps, whether or not
    the model has that weight at that shape."""
    sd = _read_reference(path)
    table = _flax_to_torch()
    return {table[p].name for p in reference_to_flat({k: _Sym(k) for k in sd})
            if p in table}


def load_model_file(model: torch.nn.Module, path: str) -> Set[str]:
    """Load a model file the port wrote into `model`, deciding as the JAX
    package's load_params_msgpack (k3m_tpu/train/state.py:94-96, flax's
    from_bytes) decides: tensors of the file that the model lacks are
    ignored (a pretraining file's heads in an alignment model) and counted
    in the log; a weight the model needs that the file lacks raises
    ValueError, as flax does, and so does a shape that differs. `path`
    holds the model's state dict (`pytorch_model.bin`) or a trainer's full
    state (`state.pt`, read through its `model` entry). Returns the names
    of the file's tensors that were ignored."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if _is_full_state(sd):
        sd = sd["model"]
    own = model.state_dict()
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise ValueError(f"{path} lacks {len(missing)} weights the model needs: "
                       f"{missing[:8]}")
    reshaped = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in own.items()
                if sd[k].shape != v.shape]
    if reshaped:
        raise ValueError(f"{path}: {len(reshaped)} weights differ in shape (name, "
                         f"file, model): {reshaped[:8]}")
    model.load_state_dict({k: sd[k] for k in own}, strict=True)
    ignored = set(sd) - set(own)
    logger.info("loaded %d weights from %s; %d tensors of the file the model lacks were "
                "ignored%s", len(own), path, len(ignored),
                f" (e.g. {sorted(ignored)[:3]})" if ignored else "")
    return ignored


def load_pretrained(model: torch.nn.Module, path: str, *, strict: bool = False,
                    require_complete: bool = False,
                    allowed_unconsumed: Tuple[str, ...] = (r"cls\.seq_relationship\.",)
                    ) -> Set[str]:
    """Load a reference or HF checkpoint into `model`, a torch file or a TF1
    checkpoint prefix (is_tf_checkpoint; read by load_tf_state_dict),
    deciding as the JAX package's load_pretrained_into_params
    (k3m_tpu/train/convert.py:316-363) decides: a source tensor is consumed
    when reference_to_flat maps it to a weight the model has, with the same
    shape; a model weight the checkpoint does not set keeps its value (a
    partial HF load, a head the checkpoint lacks) and is logged. Under
    `strict`, a source tensor left unconsumed (a renamed key, a rogue
    extra, a shape mismatch) raises ValueError unless `_IGNORABLE_SOURCE_RE`
    or one of `allowed_unconsumed` matches it; under `require_complete`, so
    does a model weight the checkpoint leaves unset (a full reference K3M
    file must set every one; a partial HF load must not ask for this). Both
    raise before the model is touched. A trainer's full state raises
    ValueError (`_read_reference`). Returns the names of the weights set."""
    if is_tf_checkpoint(path):
        sd = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in load_tf_state_dict(path.replace(".index", "")).items()}
    else:
        sd = _read_reference(path)
    own = model.state_dict()
    table = _flax_to_torch()
    loaded, consumed = {}, set()
    for flax_path, src in reference_to_flat({k: _Sym(k) for k in sd}).items():
        sym = table.get(flax_path)
        value = sd[src.name]
        if sym is None or sym.name not in own:
            continue
        if own[sym.name].shape != value.shape:
            logger.warning("shape mismatch %s: model %s, checkpoint %s", sym.name,
                           tuple(own[sym.name].shape), tuple(value.shape))
            continue
        loaded[sym.name] = value.float()
        consumed.add(src.name)
    if strict:
        allow = re.compile("|".join(allowed_unconsumed)) if allowed_unconsumed else None
        leftovers = sorted(k for k in sd if k not in consumed
                           and not _IGNORABLE_SOURCE_RE.search(k)
                           and not (allow and allow.search(k)))
        if leftovers:
            raise ValueError(f"strict load of {path}: {len(leftovers)} source tensors not "
                             f"consumed (renamed key / layout drift / shape mismatch): "
                             f"{leftovers[:8]}")
    missing = [k for k in own if k not in loaded]
    if require_complete and missing:
        raise ValueError(f"checkpoint {path} left {len(missing)} params uninitialized: "
                         f"{missing[:8]}")
    model.load_state_dict(loaded, strict=False)
    logger.info("loaded %d tensors from %s; %d model weights keep their values%s",
                len(loaded), path, len(missing), f" (e.g. {missing[:3]})" if missing else "")
    return set(loaded)


def resize_word_embeddings(model: torch.nn.Module, new_vocab_size: int, seed: int = 0,
                           initializer_range: float = 0.02) -> torch.nn.Module:
    """Grow or shrink the tied word-embedding table and the MLM decoder
    bias of `model` to `new_vocab_size`, in place: the port's copy of the
    JAX package's resize_word_embeddings (k3m_tpu/train/convert.py:373-414;
    reference `_get_resized_embeddings`, vilbert_k3m/utils.py:959-1010).
    The first min(old, new) rows are kept, new table rows are drawn from
    N(0, initializer_range) by `np.random.default_rng(seed)` as the JAX
    package draws them (one draw of the whole new table per table, in
    parameter order), and new bias rows are zero. The optimizer and the
    config's vocab_size are the caller's to rebuild."""
    rng = np.random.default_rng(seed)
    tables = [(n, m) for n, m in model.named_modules()
              if n.endswith("word_embeddings") and isinstance(m, torch.nn.Embedding)]
    if not tables:
        raise ValueError("no word_embeddings table found")
    for _, emb in tables:
        old = emb.weight.detach().cpu().numpy()
        n, h = old.shape
        new = rng.normal(0.0, initializer_range, (new_vocab_size, h)).astype(old.dtype)
        new[:min(n, new_vocab_size)] = old[:min(n, new_vocab_size)]
        emb.weight = torch.nn.Parameter(torch.from_numpy(new).to(emb.weight.device))
        emb.num_embeddings = new_vocab_size
    for name, p in list(model.named_parameters()):
        if not name.endswith("predictions.bias"):
            continue
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        old = p.detach().cpu().numpy()
        new = np.zeros((new_vocab_size,), old.dtype)
        new[:min(old.shape[0], new_vocab_size)] = old[:min(old.shape[0], new_vocab_size)]
        owner.bias = torch.nn.Parameter(torch.from_numpy(new).to(p.device))
    return model


_TRUNK_TORCH_PREFIXES = ("embeddings.", "encoder.", "v_embeddings.")


def save_reference_checkpoint(model_or_sd, path: str, bert_prefix: str = "") -> int:
    """Write a model (or its state dict) as a reference-compatible torch
    .bin under the names the JAX package's save_reference_checkpoint
    (k3m_tpu/train/convert.py:485-539, flat_to_reference) writes for the
    same weights (the reference's per-epoch `torch.save(model.state_dict(),
    ...)`, train_concap_struc.py:691-705): every weight reference_to_flat
    maps, fp32; `bert_prefix` ("bert." for HF-style names) before the
    trunk's names; the tied MLM decoder also under
    `cls.predictions.decoder.weight`, as torch's state_dict holds a tied
    weight. Weights no reference name maps are not written (logged).
    Returns the count of tensors written."""
    sd = model_or_sd.state_dict() if isinstance(model_or_sd, torch.nn.Module) else model_or_sd
    names = {sym.name for sym in _flax_to_torch().values()}
    out: Dict[str, torch.Tensor] = {}
    unmapped = []
    for name, value in sd.items():
        if name not in names:
            unmapped.append(name)
            continue
        out[bert_prefix + name if name.startswith(_TRUNK_TORCH_PREFIXES) else name] = \
            value.detach().float().cpu().contiguous()
    if unmapped:
        logger.info("%d weights without a reference name not exported (e.g. %s)",
                    len(unmapped), unmapped[:3])
    emb = out.get(bert_prefix + "embeddings.word_embeddings.weight")
    if emb is not None and "cls.predictions.transform.dense.weight" in out:
        out["cls.predictions.decoder.weight"] = emb
    torch.save(out, path)
    logger.info("exported %d tensors -> %s", len(out), path)
    return len(out)


def main(argv=None) -> int:
    """Checkpoint conversion CLI (k3m_tpu/train/convert.py:542-570):

        python -m k3m_tpu_torch.convert export --params epoch_0/pytorch_model.bin \\
            --out pytorch_model.bin [--bert_prefix bert.]

    `--params` is a model file the port wrote (`pytorch_model.bin`, or a
    trainer's full `state.pt`, read through its `model` entry)."""
    ap = argparse.ArgumentParser(prog="python -m k3m_tpu_torch.convert")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ex = sub.add_parser("export", help="the port's model file -> reference torch .bin")
    ex.add_argument("--params", required=True,
                    help="pytorch_model.bin or state.pt written by the port")
    ex.add_argument("--out", required=True, help="output pytorch_model.bin")
    ex.add_argument("--bert_prefix", default="",
                    help='"" for K3M tri-model names (default), "bert." for HF-style')
    args = ap.parse_args(argv)
    sd = torch.load(args.params, map_location="cpu", weights_only=True)
    if _is_full_state(sd):
        sd = sd["model"]
    n = save_reference_checkpoint(sd, args.out, bert_prefix=args.bert_prefix)
    print(f"exported {n} tensors -> {args.out}")
    return n


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
