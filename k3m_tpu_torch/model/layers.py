"""Core transformer building blocks (text + visual streams).

Port of k3m_tpu/model/layers.py. Module attribute names are the reference
torch names (vilbert_k3m/vilbert_k3m.py BertLayer/BertImageLayer:
`attention.self.query`, `attention.output.LayerNorm`, `intermediate.dense`,
...), so a reference state dict loads with `load_state_dict(strict=True)`.

Every LayerNorm goes through the fused LayerNorm kernel and every attention
through the fused attention kernel (k3m_tpu_torch/kernels); on CPU tensors
those run their plain PyTorch versions. Parameters are fp32. Each `Linear`
casts its input, weight and bias to the compute dtype at each use, as the
JAX package's `Dense(dtype=...)` does, so training updates fp32 master
weights; serving may cast the Linear weights once instead (`cast_linears`).
Embedding tables and LayerNorm scale/bias stay fp32. Additive masks are
fp32 [B, L] key biases ((1 - mask) * -10000).

Training (`deterministic=False`) adds the JAX package's dropout sites
(k3m_tpu/model/layers.py:330, :350, :445, :458, :496, :506), with bits from
the active StepRandom (model/random.py); attention-probability dropout runs
inside the attention kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.kernels import fused_attention, fused_layernorm
from k3m_tpu_torch.model import random as k3m_random

MASK_NEG = -10000.0


def compute_dtype(cfg: K3MConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def act_fn(name: str):
    if name == "gelu":
        return F.gelu            # erf gelu (reference :120-125)
    if name == "relu":
        return F.relu
    if name == "swish":
        return F.silu
    raise ValueError(f"unknown activation {name}")


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype` (set by set_compute_dtype;
    default the weight's dtype): input, weight and bias are cast at each
    use, so fp32 parameters get fp32 gradients through the cast."""
    compute_dtype = None

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    for m in module.modules():
        if isinstance(m, Linear):
            m.compute_dtype = dtype
    return module


def cast_linears(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every Linear's weight and bias to `dtype` in place, once (the
    serving path; training keeps fp32 weights); leaves embeddings and
    LayerNorm parameters fp32."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.to(dtype)
    return module


def init_weights(model: nn.Module, seed: int, std: float) -> nn.Module:
    """Random init from a seed, as the JAX package initializes: Linear and
    Embedding weights ~ N(0, std), biases 0, LayerNorm scale 1 / bias 0.
    Drawn on the CPU from one torch.Generator, so the same seed gives the
    same weights on every device."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.copy_(torch.normal(0.0, std, m.weight.shape, generator=g))
            if isinstance(m, nn.Linear) and m.bias is not None:
                m.bias.zero_()
    return model


def dropout(x, rate: float, deterministic: bool):
    """The JAX package's dropout (k3m_tpu/model/layers.py:89-108): uint8
    random bits against a threshold, so the keep probability is quantized
    to k/256, and kept values scaled by the exact quantized 1/keep (in x's
    dtype, as the JAX package multiplies)."""
    if deterministic or rate <= 0.0:
        return x
    t = min(max(int(round(rate * 256.0)), 1), 255)
    keep_prob = (256 - t) / 256.0
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device,
                         generator=k3m_random.active().dropout)
    scale = torch.tensor(1.0 / keep_prob, dtype=x.dtype, device=x.device)
    return x * (bits >= t).to(x.dtype) * scale


class LayerNorm(nn.Module):
    """TF-style LayerNorm, eps inside the rsqrt, fp32 statistics, optional
    residual added before normalizing (`ln(h, x)` is LN(h + x)); output in
    the compute dtype."""

    def __init__(self, dim: int, out_dtype: torch.dtype, eps: float = 1e-12):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.out_dtype = out_dtype
        self.eps = eps

    def forward(self, x, residual=None):
        return fused_layernorm(x, self.weight, self.bias, residual,
                               eps=self.eps, out_dtype=self.out_dtype)


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, L] {0,1} mask -> [B, L] additive fp32 key bias (ref :2553-2561)."""
    return (1.0 - mask.float()) * MASK_NEG


def attention_core(q, k, v, bias, dropout_rate: float = 0.0,
                   deterministic: bool = True):
    """Scaled dot-product attention over [B, L, H, D] tensors with an fp32
    [B, Lk] key bias; fp32 softmax, as the Pallas kernel computes it; in
    training the kernel drops probabilities at `dropout_rate`."""
    if deterministic or dropout_rate <= 0.0:
        return fused_attention(q, k, v, bias)
    return fused_attention(q, k, v, bias, dropout_rate=dropout_rate,
                           seed=k3m_random.active().kernel_seed())


def split_heads(x, num_heads: int):
    """[B, L, H*D] -> [B, L, H, D], a view."""
    b, l, d = x.shape
    return x.view(b, l, num_heads, d // num_heads)


def merge_heads(x):
    """[B, L, H, D] -> [B, L, H*D]."""
    b, l, h, d = x.shape
    return x.reshape(b, l, h * d)


class Dense(nn.Module):
    """`dense` Linear (reference BertIntermediate-style container)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.dense = Linear(n_in, n_out)

    def forward(self, x):
        return self.dense(x)


class DenseLayerNorm(nn.Module):
    """`dense` + post-LN with residual (reference BertSelfOutput/BertOutput)."""

    def __init__(self, n_in: int, n_out: int, out_dtype: torch.dtype):
        super().__init__()
        self.dense = Linear(n_in, n_out)
        self.LayerNorm = LayerNorm(n_out, out_dtype)

    def forward(self, h, residual, rate: float = 0.0, deterministic: bool = True):
        return self.LayerNorm(dropout(self.dense(h), rate, deterministic), residual)


class BertEmbeddings(nn.Module):
    """Word + position + type embeddings summed in fp32, then LN to the
    compute dtype (ref :335-408). `model == "roberta"` offsets position ids
    by 2 only under fix_reference_bugs (the reference recomputes them,
    k3m_tpu/model/layers.py:303-310)."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        if cfg.task_specific_tokens:
            raise NotImplementedError("task_specific_tokens is not ported yet")
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, compute_dtype(cfg))

    def forward(self, input_ids, token_type_ids, deterministic: bool = True):
        seq_len = input_ids.shape[1]
        pos_ids = torch.arange(seq_len, device=input_ids.device)
        if self.cfg.model == "roberta" and self.cfg.fix_reference_bugs:
            pos_ids = pos_ids + 2
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos_ids)[None, :, :]
             + self.token_type_embeddings(token_type_ids))
        return dropout(self.LayerNorm(x), self.cfg.hidden_dropout_prob, deterministic)


class ImageEmbeddings(nn.Module):
    """RoI feature + 5-d location projections; the location projection is
    the LN's residual (ref :2141-2161)."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.rate = cfg.hidden_dropout_prob
        self.image_embeddings = Linear(cfg.v_feature_size, cfg.v_hidden_size)
        self.image_location_embeddings = Linear(5, cfg.v_hidden_size)
        self.LayerNorm = LayerNorm(cfg.v_hidden_size, self.dtype)

    def forward(self, image_feat, image_loc, deterministic: bool = True):
        x = self.image_embeddings(image_feat.to(self.dtype))
        loc = self.image_location_embeddings(image_loc.to(self.dtype))
        return dropout(self.LayerNorm(x, loc), self.rate, deterministic)


class SelfAttention(nn.Module):
    """Multi-head self-attention (ref BertSelfAttention:411). With `gated`
    it also holds the image stream's dynamic-attention projections
    `dyLinear_q`/`dyLinear_k` (ref :572-601), which ImageLayer applies."""

    def __init__(self, cfg: K3MConfig, hidden: int, num_heads: int,
                 attn_dropout: float, gated: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.attn_dropout = attn_dropout
        self.query = Linear(hidden, hidden)
        self.key = Linear(hidden, hidden)
        self.value = Linear(hidden, hidden)
        if gated:
            self.dyLinear_q = Linear(cfg.hidden_size, hidden)
            self.dyLinear_k = Linear(cfg.hidden_size, hidden)

    def forward(self, x, bias, gate_q=None, gate_k=None, deterministic: bool = True):
        q, k, v = self.query(x), self.key(x), self.value(x)
        if gate_q is not None:
            q = q * gate_q[:, None, :]
        if gate_k is not None:
            k = k * gate_k[:, None, :]
        h = self.num_heads
        ctx = attention_core(split_heads(q, h), split_heads(k, h),
                             split_heads(v, h), bias, self.attn_dropout, deterministic)
        return merge_heads(ctx)


class Attention(nn.Module):
    """`self` attention + `output` projection/LN (ref BertAttention)."""

    def __init__(self, cfg: K3MConfig, hidden: int, num_heads: int,
                 attn_dropout: float, gated: bool = False):
        super().__init__()
        self.self = SelfAttention(cfg, hidden, num_heads, attn_dropout, gated)
        self.output = DenseLayerNorm(hidden, hidden, compute_dtype(cfg))


class TextLayer(nn.Module):
    """BertLayer: self-attention + output + FFN, post-LN (ref :535-548)."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        self.act = act_fn(cfg.hidden_act)
        self.rate = cfg.hidden_dropout_prob
        self.attention = Attention(cfg, cfg.hidden_size, cfg.num_attention_heads,
                                   cfg.attention_probs_dropout_prob)
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = DenseLayerNorm(cfg.intermediate_size, cfg.hidden_size, dt)

    def forward(self, x, bias, deterministic: bool = True):
        det = deterministic
        a = self.attention.output(self.attention.self(x, bias, deterministic=det), x,
                                  self.rate, det)
        return self.output(self.act(self.intermediate(a)), a, self.rate, det)


class ImageLayer(nn.Module):
    """BertImageLayer with optional text-conditioned QK gating
    (ref :551-709): gates = 1 + sigmoid(W pooled_text)."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        self.dynamic = cfg.dynamic_attention
        self.act = act_fn(cfg.v_hidden_act)
        self.rate = cfg.v_hidden_dropout_prob
        self.attention = Attention(cfg, cfg.v_hidden_size,
                                   cfg.v_num_attention_heads,
                                   cfg.v_attention_probs_dropout_prob,
                                   gated=cfg.dynamic_attention)
        self.intermediate = Dense(cfg.v_hidden_size, cfg.v_intermediate_size)
        self.output = DenseLayerNorm(cfg.v_intermediate_size,
                                     cfg.v_hidden_size, dt)

    def forward(self, x, bias, txt_embedding=None, txt_mask2=None,
                deterministic: bool = True):
        gate_q = gate_k = None
        sa = self.attention.self
        if self.dynamic and txt_embedding is not None:
            pooled = (txt_embedding * txt_mask2).sum(1) / txt_mask2.sum(1)
            gate_q = 1.0 + torch.sigmoid(sa.dyLinear_q(pooled))
            gate_k = 1.0 + torch.sigmoid(sa.dyLinear_k(pooled))
        det = deterministic
        a = self.attention.output(sa(x, bias, gate_q, gate_k, deterministic=det), x,
                                  self.rate, det)
        return self.output(self.act(self.intermediate(a)), a, self.rate, det)


def adopt(parent: nn.Module, name: str, child: nn.Module) -> nn.Module:
    """Make `child` callable as `parent.<name>` while registering its
    submodules directly on `parent`: the reference keeps these parameters
    at its owner's top level (`score_self_t`, `struc_w1`, ...), so their
    state-dict names carry no prefix for `child`."""
    for sub_name, sub in child.named_children():
        parent.add_module(sub_name, sub)
    object.__setattr__(parent, name, child)
    return child
