"""Tensor parallelism: which weights the model ranks split, and how.

The counterpart of the 'model' axis of k3m_tpu/train/mesh.py (param rules
:41-58), in the port's parameter names (the reference torch names):

  column-parallel, the output dim (torch's dim 0) split: the query, key
      and value Linears of every text and image layer and of every
      co-attention's `biattention` (query1 .. value2), and the FFN-in
      Linears (`intermediate`, `v_intermediate`, `t_intermediate`); their
      biases go with them;
  row-parallel, the input dim (torch's dim 1) split: the attention-out
      and FFN-out Linears (`attention.output.dense`, `output.dense`,
      `v_output.dense`, `t_output.dense`, `biOutput.dense1/2`); their
      biases are replicated and added once, after the sum;
  vocab-parallel, the rows split: the word table
      (`embeddings.word_embeddings`) and, because the MLM decoder is tied
      to it, the decoder's output bias (`cls.predictions.bias`);
  replicated: everything else (LayerNorms, position and type embeddings,
      `dyLinear_q/k`, the image embeddings, the heads' transforms, fusion,
      the structure aggregator, the classifier).

The JAX package's rules match kernels only, so its biases stay replicated
(GSPMD adds a replicated bias to a sharded output alike); the port splits
the column-parallel biases with their weights, which is the same
function. Where a width does not divide by `n_model`, JAX raises (a
sharded dimension must divide), and so does the port, by name
(`check_model_axis`). A head count that `n_model` does not divide (the 12
text heads at `--n_model 8`) is no width: the JAX kernels run that
attention replicated over the model axis, and so do the port's layers
(model/layers.py `HeadParallel`).

`shard_model` replaces each split weight by this model rank's slice, in
place (the Parameter objects stay, so an optimizer made before keeps
them, and are marked `tp_split`), and tells the layers (model/layers.py, model/coattention.py,
model/heads.py) their model ranks, first head and first vocab row; it runs
after every load and conversion, on the full model. `full_state_dict`
and `full_optimizer_state` gather the slices over the model group, so a
checkpoint is the file one process writes; `local_state_dict` and
`local_optimizer_state` cut a full checkpoint back to this rank's slices.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import torch

from k3m_tpu_torch.dist import World

_COLUMN = re.compile(r"(attention\.self\.(query|key|value)|biattention\.(query|key|value)[12]"
                     r"|(^|\.)(v_|t_)?intermediate\.dense)\.(weight|bias)$")
_ROW = re.compile(r"((^|\.)(output|v_output|t_output)\.dense|biOutput\.dense[12])\.weight$")
_VOCAB = re.compile(r"(^|\.)(embeddings\.word_embeddings\.weight|cls\.predictions\.bias)$")


def shard_dim(name: str) -> Optional[int]:
    """The dim of parameter `name` that the model ranks split (0 for
    column-parallel and vocab-parallel, 1 for row-parallel), None where it
    is replicated."""
    if _COLUMN.search(name) or _VOCAB.search(name):
        return 0
    if _ROW.search(name):
        return 1
    return None


def check_model_axis(cfg, n_model: int) -> None:
    """Raise, naming the width, where `n_model` does not divide a sharded
    width (the Q/K/V and FFN columns, the vocab) of the model `cfg`
    builds. A head count need not divide: such a layer runs every head on
    each model rank (model/layers.py `HeadParallel`)."""
    if n_model < 1:
        raise ValueError(f"--n_model {n_model} < 1")
    if n_model > 1 and cfg.text_block != "bert":
        raise ValueError(f"--n_model {n_model}: tensor parallelism is not built for the "
                         f"{cfg.text_block!r} text block (ROADMAP.md); use data "
                         "parallelism (--n_model 1)")
    widths = [("hidden_size", cfg.hidden_size), ("intermediate_size", cfg.intermediate_size)]
    if cfg.use_image:
        widths += [("v_hidden_size", cfg.v_hidden_size),
                   ("v_intermediate_size", cfg.v_intermediate_size)]
        if cfg.with_coattention:
            widths.append(("bi_hidden_size", cfg.bi_hidden_size))
    for name, n in widths + [("vocab_size", cfg.vocab_size)]:
        if n % n_model:
            raise ValueError(f"--n_model {n_model} does not divide {name} {n} (tensor "
                             "parallelism splits it evenly, as the JAX package does; "
                             "ROADMAP.md Queue 1, item 9)")


def shard_tensor(t: torch.Tensor, dim: int, world: World) -> torch.Tensor:
    """This model rank's slice of the full tensor `t` along `dim`."""
    n = t.shape[dim] // world.n_model
    return t.narrow(dim, world.model_rank * n, n)


def gather_tensor(t: torch.Tensor, dim: int, world: World) -> torch.Tensor:
    """The full tensor of every model rank's slice `t` along `dim`, on
    every rank of the model group (placed in a zeroed buffer and summed:
    exact in any type)."""
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * world.n_model
    buf = t.new_zeros(shape)
    buf.narrow(dim, world.model_rank * n, n).copy_(t)
    return world.all_reduce_sum(buf, "model")


def shard_model(model: torch.nn.Module, world: World) -> torch.nn.Module:
    """Split `model`'s weights over `world`'s model ranks, in place (a full
    model; a model already split over them is returned as it is)."""
    from k3m_tpu_torch.model.coattention import BiAttention
    from k3m_tpu_torch.model.heads import LMPredictionHead
    from k3m_tpu_torch.model.layers import BertEmbeddings, Dense, Linear, SelfAttention
    M, r = world.n_model, world.model_rank
    if getattr(model, "tp", 1) == M:
        return model
    if getattr(model, "tp", 1) != 1:
        raise ValueError(f"the model is split over {model.tp} model ranks, not {M}")
    check_model_axis(model.cfg, M)
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = shard_dim(name)
            if dim is not None:
                p.data = shard_tensor(p.data, dim, world).clone()
                p.tp_split = True
    vocab0 = r * (model.cfg.vocab_size // M)
    for name, m in model.named_modules():
        if isinstance(m, (SelfAttention, BiAttention)):
            m.tp, m.model_rank = M, r
        elif isinstance(m, Dense):
            m.tp = M
        elif isinstance(m, (BertEmbeddings, LMPredictionHead)):
            m.tp, m.vocab0 = M, vocab0
        elif isinstance(m, Linear) and shard_dim(f"{name}.weight") == 1:
            m.parallel, m.tp = "row", M
    model.tp = M
    return model


def full_state_dict(model: torch.nn.Module, world: World) -> Dict[str, torch.Tensor]:
    """`model.state_dict()` with every split tensor gathered to its full
    shape (every rank of the model group calls it)."""
    sd = model.state_dict()
    if world.n_model == 1:
        return sd
    out = {}
    for k, v in sd.items():
        dim = shard_dim(k)
        out[k] = v if dim is None else gather_tensor(v, dim, world)
    return out


def local_state_dict(sd: Dict[str, torch.Tensor], world: World) -> Dict[str, torch.Tensor]:
    """A full state dict cut to this model rank's slices."""
    if world.n_model == 1:
        return sd
    out = {}
    for k, v in sd.items():
        dim = shard_dim(k)
        out[k] = v if dim is None else shard_tensor(v, dim, world)
    return out


def optimizer_names(model: torch.nn.Module, opt: torch.optim.Optimizer) -> List[str]:
    """The parameter name of each index of `opt.state_dict()["state"]`
    (its params numbered in the order of its groups)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in opt.param_groups for p in g["params"]]


def _map_moments(state: dict, names: List[str], fn) -> dict:
    """`state` (an optimizer state dict) with `fn(tensor, dim)` applied to
    each per-element tensor (the AdamW moments) of a split parameter, in
    index order."""
    out = dict(state, state={})
    for idx in sorted(state["state"]):
        dim = shard_dim(names[idx])
        out["state"][idx] = {k: fn(v, dim) if dim is not None and torch.is_tensor(v)
                             and v.dim() > 0 else v
                             for k, v in state["state"][idx].items()}
    return out


def full_optimizer_state(state: dict, names: List[str], world: World) -> dict:
    """An optimizer state dict with each split parameter's moments gathered
    to full shape (every rank of the model group calls it)."""
    if world.n_model == 1:
        return state
    return _map_moments(state, names, lambda v, dim: gather_tensor(v, dim, world))


def local_optimizer_state(state: dict, names: List[str], world: World) -> dict:
    """A full optimizer state dict cut to this model rank's slices."""
    if world.n_model == 1:
        return state
    return _map_moments(state, names, lambda v, dim: shard_tensor(v, dim, world))
