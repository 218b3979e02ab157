"""The plain reference of the DeepSeek-V2 text block's pretraining cell:
k3m_plain's K3MForPretraining (the frozen plain copy of the K3M model) with
its text stack, its embeddings and its loss composed from the frozen plain
DeepSeek-V2 layer (deepseek_plain.py), as the program composes them
(k3m_tpu_torch/model/deepseek.py, encoder.py, pretrain.py):

  * `encoder.layer` holds DeepSeek-V2's layers (layer 0 dense, the others
    MoE over the configuration's held experts), and every text stream's
    output after the stack's last layer goes through `encoder.norm`;
  * `embeddings` is the token embedding alone, in the model's dtype;
  * the output gains `moe_balance_loss`, the MoE layers' sequence-wise
    balance loss, which `total_loss` adds to K3M's four terms.

Parameter names are the program's, so that benchmark/lib/weights_moe.py
gives both sides the same weights. `routes()` records the experts each
MoE layer chose, in the program's row order; `lower_precision()` is the
control (reference/control.py, with the DeepSeek-V2 layers' products and
attention operands rounded to fp8 too).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
from torch import nn

from benchmark.reference import control
from benchmark.reference import deepseek_plain as dsp
from benchmark.reference.k3m_plain import encoder as k3m_encoder
from benchmark.reference.k3m_plain import pretrain as k3m_pretrain
from benchmark.reference.k3m_plain.config import K3MConfig
from benchmark.reference.k3m_plain.layers import compute_dtype

LOSS_KEYS = ("loss", "masked_lm_loss", "masked_img_loss", "masked_lm_loss_pv", "loss_struc",
             "moe_balance_loss")


class Encoder(k3m_encoder.TriStreamEncoder):
    """k3m_plain's encoder with the final RMSNorm on every text stream's
    output after the last text layer."""

    def _run_text(self, x, bias, start, end, det):
        x = super()._run_text(x, bias, start, end, det)
        return self.norm(x) if end == self.cfg.num_hidden_layers else x

    def _run_text_packed(self, xs, biases, start, end, det):
        xs = super()._run_text_packed(xs, biases, start, end, det)
        return [self.norm(x) for x in xs] if end == self.cfg.num_hidden_layers else xs


class TokenEmbeddings(nn.Module):
    def __init__(self, vocab: int, hidden: int, dtype):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab, hidden)
        self.dtype = dtype

    def forward(self, input_ids, token_type_ids=None, deterministic=True, task_ids=None):
        return self.word_embeddings(input_ids).to(self.dtype)


class Pretraining(k3m_pretrain.K3MForPretraining):
    """k3m_plain's pretraining model whose forward adds the balance loss."""

    def forward(self, batch, **kwargs):
        out = super().forward(batch, **kwargs)
        out["moe_balance_loss"] = dsp.balance_loss(self.encoder.layer, self.alpha)
        return out


def k3m_config(config: dict, dtype: str) -> K3MConfig:
    """k3m_plain's configuration of the K3M parts: the configuration's keys
    in `dtype`, silu under its other name, and a position table of one row
    (the token embedding replaces BERT's)."""
    cfg = K3MConfig.from_dict(dict(config, dtype=dtype, max_position_embeddings=1))
    return cfg.replace(hidden_act="swish") if cfg.hidden_act == "silu" else cfg


def build(config: dict, dtype: str = "float32") -> Pretraining:
    """The reference model of `config` (module docstring) on the current
    default device; its weights are to be drawn (weights_moe.fill_weights)."""
    cfg = k3m_config(config, dtype)
    dcfg = dsp.DeepSeekV2Config.from_dict(config)
    model = Pretraining(cfg)
    model.alpha = dcfg.aux_loss_alpha
    enc = model.encoder
    enc.__class__ = Encoder
    enc.layer = nn.ModuleList(dsp.DeepSeekV2Layer(dcfg, i) for i in range(cfg.num_hidden_layers))
    enc.norm = dsp._Norm(cfg.hidden_size, dcfg.rms_norm_eps)
    emb = TokenEmbeddings(cfg.vocab_size, cfg.hidden_size, compute_dtype(cfg))
    model.trunk.embeddings = emb
    model._modules["embeddings"] = emb
    return model


def total_loss(out):
    """(loss, metrics): K3M's four terms and the balance loss."""
    loss = (out["masked_lm_loss"] + out["masked_img_loss"] + out["masked_lm_loss_pv"]
            + out["loss_struc"] + out["moe_balance_loss"])
    return loss, dict(loss=loss, **{k: out[k] for k in LOSS_KEYS[1:]})


@contextlib.contextmanager
def routes():
    """Record the experts each MoE layer chose (host int tensors [rows,
    k]), one entry per layer call, the streams of a packed call joined in
    their order: the program's row order."""
    got: List[torch.Tensor] = []
    calls: Dict[int, List[torch.Tensor]] = {}
    saved_forward, saved_route = dsp.DeepSeekV2Layer.forward, dsp.MoE.route

    def route(self, u):
        s, w, idx = saved_route(self, u)
        calls.setdefault(id(self), []).append(idx.reshape(-1, idx.shape[-1]).cpu())
        return s, w, idx

    def forward(self, x, bias, deterministic=True):
        out = saved_forward(self, x, bias, deterministic)
        if self.moe:
            got.append(torch.cat(calls.pop(id(self.mlp))))
        return out

    dsp.DeepSeekV2Layer.forward, dsp.MoE.route = forward, route
    try:
        yield got
    finally:
        dsp.DeepSeekV2Layer.forward, dsp.MoE.route = saved_forward, saved_route


def _fp8_weight(self, x):
    return control.fp8(x, x.dtype) @ control.fp8(self.weight, x.dtype).t()


def _fp8_expert(self, e, x):
    g, up = (control.fp8(x, x.dtype) @ control.fp8(self.w13[e], x.dtype)).chunk(2, dim=-1)
    h = torch.nn.functional.silu(g) * up
    return control.fp8(h, h.dtype) @ control.fp8(self.w2[e], h.dtype)


@contextlib.contextmanager
def lower_precision():
    """The control: reference/control.py's fp8 products in the K3M parts,
    and in the DeepSeek-V2 layers every product's operands rounded to fp8
    (the projections, the experts and the attention's scores and values)."""
    saved = dsp._Weight.forward, dsp.Experts.expert, torch.einsum
    real_einsum = torch.einsum

    def einsum(eq, *ops):
        return real_einsum(eq, *(control.fp8(o, o.dtype) if o.is_floating_point() else o
                                 for o in ops))

    dsp._Weight.forward, dsp.Experts.expert = _fp8_weight, _fp8_expert
    dsp.torch.einsum = einsum
    try:
        with control.lower_precision():
            yield
    finally:
        dsp._Weight.forward, dsp.Experts.expert, _ = saved
        dsp.torch.einsum = real_einsum
