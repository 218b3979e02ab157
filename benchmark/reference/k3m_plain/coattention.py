"""ViLBERT-style bi-directional co-attention (cross-stream) layers.

Port of k3m_tpu/model/coattention.py (reference BertBiAttention:712,
BertBiAttention_two_text:841, BertBiOutput:968, BertConnectionLayer:1030,
BertConnectionLayer_two_text:1074). Both attention directions run in one
launch of the fused bi-attention kernel, which in training also drops the
probabilities: `dropout1` those over stream 1's values
(v_attention_probs_dropout_prob), `dropout2` those over stream 2's
(attention_probs_dropout_prob), for both connection types
(k3m_tpu/model/coattention.py:112-116, :174-178). The hidden dropouts follow
coattention.py:120-154 and :180-212; the two-text layer drops its stream-1
FFN output at the text rate. The reference's dead `q_dense*` parameters
are not created.

Under tensor parallelism (train/mesh.py) `BiAttention` is column-parallel
(over its heads where the model ranks divide them, else replicated,
layers.HeadParallel), `biOutput.dense1/dense2` and `v_output`/`t_output` are
row-parallel and `v_intermediate`/`t_intermediate` column-parallel, as the
JAX package's param rules give them (k3m_tpu/train/mesh.py:41-58).
"""

from __future__ import annotations

from torch import nn

from .config import K3MConfig
from .coattn import fused_biattention
from . import rand as k3m_random
from . import visualize
from .layers import (
    Dense, DenseLayerNorm, HeadParallel, LayerNorm, Linear, act_fn, compute_dtype, dropout,
    fused_dense, merge_heads, split_heads, unfused_attention,
)
from . import dist


class BiAttention(HeadParallel, nn.Module):
    """Cross attention between stream 1 (visual-like) and stream 2
    (text-like). Returns (ctx1, ctx2) in reference order: ctx1 = stream-2
    queries over stream 1 [B, L2, bi], ctx2 = stream-1 queries over
    stream 2 [B, L1, bi]; each bias is its key stream's. Under tensor
    parallelism see layers.HeadParallel (both directions alike). Under
    `visualization` each direction runs `unfused_attention` and records
    its probabilities as the JAX package sows them: `attn1` (stream-2
    queries over stream 1), `attn2` (the reverse). Under `fused_qkv` each
    stream's three projections are one (layers.fused_dense,
    k3m_tpu/model/coattention.py:50-59), and the kernel reads q/k/v as
    views of it."""

    def __init__(self, size1: int, size2: int, bi_size: int, num_heads: int,
                 dropout1: float = 0.0, dropout2: float = 0.0,
                 visualization: bool = False, fused_qkv: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dropout1, self.dropout2 = dropout1, dropout2
        self.visualization = visualization
        self.fused_qkv = fused_qkv
        self.query1 = Linear(size1, bi_size)
        self.key1 = Linear(size1, bi_size)
        self.value1 = Linear(size1, bi_size)
        self.query2 = Linear(size2, bi_size)
        self.key2 = Linear(size2, bi_size)
        self.value2 = Linear(size2, bi_size)

    def forward(self, x1, bias1, x2, bias2, deterministic: bool = True):
        h = self.run_heads
        x1, x2 = dist.copy_to_model(x1, self.tp), dist.copy_to_model(x2, self.tp)
        if self.fused_qkv:
            p1 = fused_dense(x1, (self.query1, self.key1, self.value1))
            p2 = fused_dense(x2, (self.query2, self.key2, self.value2))
        else:
            p1 = (self.query1(x1), self.key1(x1), self.value1(x1))
            p2 = (self.query2(x2), self.key2(x2), self.value2(x2))
        q1, k1, v1, q2, k2, v2 = (split_heads(self.gather_heads(t), h) for t in p1 + p2)
        if self.visualization:
            ctx1, probs1 = unfused_attention(q2, k1, v1, bias1, self.dropout1, deterministic)
            ctx2, probs2 = unfused_attention(q1, k2, v2, bias2, self.dropout2, deterministic)
            visualize.record(self, "attn1", probs1)
            visualize.record(self, "attn2", probs2)
        else:
            drop = dict(dropout1=0.0 if deterministic else self.dropout1,
                        dropout2=0.0 if deterministic else self.dropout2)
            if drop["dropout1"] > 0.0 or drop["dropout2"] > 0.0:
                drop["seed"] = k3m_random.active().kernel_seed()
                drop["row0"] = dist.window(x1.shape[0])[0]
                drop["head0"], drop["heads_global"] = self.head0, self.num_heads
            ctx1, ctx2 = fused_biattention(q1, k1, v1, bias1, q2, k2, v2, bias2, **drop)
        return (self.own_columns(merge_heads(ctx1)), self.own_columns(merge_heads(ctx2)))


class BiOutput(nn.Module):
    """ctx2 back onto stream 1, ctx1 back onto stream 2, each with a
    post-LN residual (ref BertBiOutput:968)."""

    def __init__(self, bi_size: int, size1: int, size2: int, dt):
        super().__init__()
        self.dense1 = Linear(bi_size, size1)
        self.LayerNorm1 = LayerNorm(size1, dt)
        self.dense2 = Linear(bi_size, size2)
        self.LayerNorm2 = LayerNorm(size2, dt)


class _Connection(nn.Module):
    def __init__(self, cfg: K3MConfig, size1: int, bi_size: int,
                 inter1: int, act1: str, ffn1_rate: float):
        super().__init__()
        dt = compute_dtype(cfg)
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.act1, self.act2 = act_fn(act1), act_fn(cfg.hidden_act)
        # hidden dropout rates: biOutput stream 1, stream 2; FFN 1, FFN 2
        self.rates = (cfg.v_hidden_dropout_prob, cfg.hidden_dropout_prob,
                      ffn1_rate, cfg.hidden_dropout_prob)
        self.biattention = BiAttention(size1, H, bi_size,
                                       cfg.bi_num_attention_heads,
                                       cfg.v_attention_probs_dropout_prob,
                                       cfg.attention_probs_dropout_prob,
                                       cfg.visualization, cfg.fused_qkv)
        self.biOutput = BiOutput(bi_size, size1, H, dt)
        self.v_intermediate = Dense(size1, inter1)
        self.v_output = DenseLayerNorm(inter1, size1, dt)
        self.t_intermediate = Dense(H, I)
        self.t_output = DenseLayerNorm(I, H, dt)

    def forward(self, x1, bias1, x2, bias2, deterministic: bool = True):
        det = deterministic
        r_s1, r_s2, r_h1, r_h2 = self.rates
        ctx1, ctx2 = self.biattention(x1, bias1, x2, bias2, det)
        o = self.biOutput
        s1 = o.LayerNorm1(dropout(o.dense1(ctx2), r_s1, det), x1)
        s2 = o.LayerNorm2(dropout(o.dense2(ctx1), r_s2, det), x2)
        out1 = self.v_output(self.act1(self.v_intermediate(s1)), s1, r_h1, det)
        out2 = self.t_output(self.act2(self.t_intermediate(s2)), s2, r_h2, det)
        return out1, out2


class ConnectionLayer(_Connection):
    """BertConnectionLayer (ref :1030-1071): stream 1 is visual-sized,
    stream 2 text-sized; bi_num_attention_heads over bi_hidden_size."""

    def __init__(self, cfg: K3MConfig):
        super().__init__(cfg, cfg.v_hidden_size, cfg.bi_hidden_size,
                         cfg.v_intermediate_size, cfg.v_hidden_act,
                         cfg.v_hidden_dropout_prob)


class ConnectionLayerTwoText(_Connection):
    """BertConnectionLayer_two_text (ref :1074-1111): both streams
    text-sized, bi_num_attention_heads over hidden_size (8 heads over 768:
    head dim 96), both FFNs text-sized."""

    def __init__(self, cfg: K3MConfig):
        super().__init__(cfg, cfg.hidden_size, cfg.hidden_size,
                         cfg.intermediate_size, cfg.hidden_act,
                         cfg.hidden_dropout_prob)
