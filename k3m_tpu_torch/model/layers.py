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

Two options of the config change how the rows meet the weights, not the
math per row (the JAX package's k3m_tpu/model/layers.py:179-263):
`fused_qkv` computes each attention site's Q/K/V as one `F.linear` over
the concatenated `query`/`key`/`value` weights (`fused_dense`; the Linear
modules stay, so the state dict is the same), and `packed_passes` hands the
text layers `Packed` rows of several streams: every projection, FFN,
dropout and LayerNorm runs once over all of them, attention per stream
(TextLayer, SelfAttention).

Under `config.visualization` every attention site runs the unfused
attention in torch ops instead of the attention kernels and records its
probabilities (model/visualize.py), as the JAX package's unfused path
sows them.

Training (`deterministic=False`) adds the JAX package's dropout sites
(k3m_tpu/model/layers.py:330, :350, :445, :458, :496, :506), with bits from
the active StepRandom (model/random.py); attention-probability dropout runs
inside the attention kernels.

Tensor parallelism (train/mesh.py `shard_model`, the JAX package's
'model' axis rules): a sharded layer holds this model rank's slice of its
weights and its `tp` (the model ranks). The query/key/value and FFN-in
Linears are column-parallel: their owners (`SelfAttention`, `Dense`,
coattention's `BiAttention`) take the replicated input through
`dist.copy_to_model` and compute the local heads or columns (every head,
on Q/K/V gathered over the model group, where the heads do not divide
the model ranks: `HeadParallel`); the
attention-out and FFN-out Linears are row-parallel (`Linear.parallel ==
"row"`): the local partial product is summed over the model group
(`dist.reduce_from_model`) before the bias, the dropout and the LN kernel,
so every activation outside those layers stays replicated. The word
embedding is vocab-parallel. With `tp` 1 every layer runs the
one-process code.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.kernels import fused_attention, fused_layernorm
from k3m_tpu_torch.model import random as k3m_random
from k3m_tpu_torch.model import visualize
from k3m_tpu_torch import dist

MASK_NEG = -10000.0


def compute_dtype(cfg: K3MConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def act_fn(name: str):
    if name == "gelu":
        return F.gelu            # erf gelu (reference :120-125)
    if name == "relu":
        return F.relu
    if name in ("swish", "silu"):
        return F.silu
    raise ValueError(f"unknown activation {name}")


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype` (set by set_compute_dtype;
    default the weight's dtype): input, weight and bias are cast at each
    use, so fp32 parameters get fp32 gradients through the cast. Row-parallel
    (`parallel` "row", `tp` model ranks; train/mesh.py): the weight's input
    columns are this rank's, and the partial products are summed over the
    model group before the bias is added once."""
    compute_dtype = None
    parallel = None
    tp = 1

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        if self.parallel == "row":
            y = dist.reduce_from_model(F.linear(x.to(dt), self.weight.to(dt)), self.tp)
            return y if bias is None else y + bias
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
    same weights on every device. A module with `init_drawn` (the held
    experts' weight banks, model/deepseek.py) draws its own from the same
    generator, in module order."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.copy_(torch.normal(0.0, std, m.weight.shape, generator=g))
            if isinstance(m, nn.Linear) and m.bias is not None:
                m.bias.zero_()
            if hasattr(m, "init_drawn"):
                m.init_drawn(g, std)
    return model


def dropout(x, rate: float, deterministic: bool, shapes=None):
    """The JAX package's dropout (k3m_tpu/model/layers.py:89-108): uint8
    random bits (drawn for the global batch, `rows_randint`) against a
    threshold, so the keep probability is quantized
    to k/256, and kept values scaled by the exact quantized 1/keep (in x's
    dtype, as the JAX package multiplies). With `shapes`, x is the packed
    rows of streams of those (B, L_i) shapes (`Packed`) and the bits are
    `packed_bits`."""
    if deterministic or rate <= 0.0:
        return x
    t = min(max(int(round(rate * 256.0)), 1), 255)
    keep_prob = (256 - t) / 256.0
    gen = k3m_random.active().dropout
    if shapes is None:
        bits = k3m_random.rows_randint(gen, 256, x.shape, x.device, torch.uint8)
    else:
        bits = packed_bits(gen, shapes, x.shape[-1], x.device)
    scale = torch.tensor(1.0 / keep_prob, dtype=x.dtype, device=x.device)
    return x * (bits >= t).to(x.dtype) * scale


def packed_bits(generator, shapes, width: int, device):
    """uint8 dropout bits of the packed rows of streams of `shapes` (B,
    L_i), all of batch B: drawn as one [B, sum L_i, width] tensor with the
    batch on dim 0 (`rows_randint`: the global batch's bits, this rank's
    rows), then reordered into packed order (stream i's B * L_i rows after
    those of the streams before it). So N data ranks drop what one process
    drops for their concatenated batch, as for a single stream."""
    B = shapes[0][0]
    if any(b != B for b, _ in shapes):
        raise ValueError(f"packed streams of different batches {shapes}")
    lengths = [L for _, L in shapes]
    bits = k3m_random.rows_randint(generator, 256, (B, sum(lengths), width), device,
                                   torch.uint8)
    return torch.cat([part.reshape(-1, width) for part in bits.split(lengths, dim=1)])


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


def unfused_attention(q, k, v, bias, dropout_rate: float = 0.0,
                      deterministic: bool = True):
    """(ctx, probs): the JAX package's unfused attention
    (k3m_tpu/model/layers.py:210-232), which `config.visualization`
    selects, in torch ops: fp32 scores / sqrt(D) + bias stored in v's
    dtype, an fp32 softmax stored in v's dtype, the probabilities dropped
    (this module's `dropout`), the post-dropout [B, H, Lq, Lk] probabilities
    kept for the attention maps, then times v in fp32. The JAX config
    refuses visualization with `use_pallas` because the fused kernels
    never form the probabilities; here too no attention kernel runs in
    this mode (the LayerNorm kernel still does)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    scores = (scores + bias.float()[:, None, None, :]).to(v.dtype)
    probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    probs = dropout(probs, dropout_rate, deterministic)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return ctx.to(v.dtype), probs


def attention_core(q, k, v, bias, dropout_rate: float = 0.0,
                   deterministic: bool = True, head0: int = 0, heads_global=None):
    """Scaled dot-product attention over [B, L, H, D] tensors with an fp32
    [B, Lk] key bias; fp32 softmax, as the Pallas kernel computes it; in
    training the kernel drops probabilities at `dropout_rate`, the H heads
    drawing the mask of heads head0 .. head0 + H - 1 of `heads_global`."""
    if deterministic or dropout_rate <= 0.0:
        return fused_attention(q, k, v, bias)
    # one call per slice of the global rows: one, but two for the image
    # stack of packed_passes under data parallelism (dist.stacked), whose
    # copies' rows are not adjacent there; one seed for all of them
    seed = k3m_random.active().kernel_seed()
    outs, o = [], 0
    for row0, n in dist.windows(q.shape[0])[0]:
        outs.append(fused_attention(q[o:o + n], k[o:o + n], v[o:o + n], bias[o:o + n],
                                    dropout_rate=dropout_rate, seed=seed, row0=row0,
                                    head0=head0, heads_global=heads_global))
        o += n
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def pack_rows(xs):
    """Streams [B, L_i, H] -> ([sum B * L_i, H] rows, ((B, L_i), ...))
    (k3m_tpu/model/layers.py:179-189)."""
    shapes = tuple((x.shape[0], x.shape[1]) for x in xs)
    return torch.cat([x.reshape(-1, x.shape[-1]) for x in xs]), shapes


def unpack_rows(rows, shapes):
    """The streams of `pack_rows`' rows as [B, L_i, ...] views (the rows'
    trailing dims, which may differ from the packed input's; rows may be a
    view with a row stride, as a column slice of one fused projection is)."""
    outs, o = [], 0
    for b, l in shapes:
        outs.append(rows[o:o + b * l].unflatten(0, (b, l)))
        o += b * l
    return tuple(outs)


class Packed:
    """Row-packed streams (k3m_tpu/model/layers.py:192-226): `rows`
    [sum B * L_i, H] and the streams' (B, L_i) `shapes`. Text layers take
    and return it, so the rows stay packed across a segment of layers and
    are copied only where it starts (`pack`) and viewed where it ends
    (`unpack`)."""

    def __init__(self, rows, shapes):
        self.rows = rows
        self.shapes = tuple(tuple(s) for s in shapes)

    @classmethod
    def pack(cls, xs):
        return cls(*pack_rows(tuple(xs)))

    def unpack(self):
        return unpack_rows(self.rows, self.shapes)


def fused_dense(x, linears):
    """The outputs of the same-input `linears` from one `F.linear` over
    their concatenated weights and biases (k3m_tpu/model/layers.py:248-263,
    `fused_qkv`): the concatenation is made at each call, as the JAX
    package makes it at apply time, and cast to the compute dtype once, so
    the Linear modules keep their parameters (the state dict, checkpoint
    conversion and train/mesh.py's rules see no difference) and their
    gradients. Under tensor parallelism each Linear holds this rank's
    columns, and so does the product. Returns column views of one
    [..., sum of the widths] tensor, each with that row stride."""
    first = linears[0]
    dt = first.compute_dtype or first.weight.dtype
    w = torch.cat([m.weight for m in linears]).to(dt)
    b = None if first.bias is None else torch.cat([m.bias for m in linears]).to(dt)
    return F.linear(x.to(dt), w, b).split([m.weight.shape[0] for m in linears], dim=-1)


def split_heads(x, num_heads: int):
    """[B, L, H*D] -> [B, L, H, D], a view."""
    b, l, d = x.shape
    return x.view(b, l, num_heads, d // num_heads)


def merge_heads(x):
    """[B, L, H, D] -> [B, L, H*D]."""
    b, l, h, d = x.shape
    return x.reshape(b, l, h * d)


class Dense(nn.Module):
    """`dense` Linear (reference BertIntermediate-style container);
    column-parallel under tensor parallelism (`tp` model ranks): the
    output columns are this rank's."""
    tp = 1

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.dense = Linear(n_in, n_out)

    def forward(self, x):
        return self.dense(dist.copy_to_model(x, self.tp))


class DenseLayerNorm(nn.Module):
    """`dense` + post-LN with residual (reference BertSelfOutput/BertOutput)."""

    def __init__(self, n_in: int, n_out: int, out_dtype: torch.dtype):
        super().__init__()
        self.dense = Linear(n_in, n_out)
        self.LayerNorm = LayerNorm(n_out, out_dtype)

    def forward(self, h, residual, rate: float = 0.0, deterministic: bool = True,
                shapes=None):
        return self.LayerNorm(dropout(self.dense(h), rate, deterministic, shapes), residual)


class BertEmbeddings(nn.Module):
    """Word + position + type embeddings summed in fp32, then LN to the
    compute dtype (ref :335-408). `model == "roberta"` offsets position ids
    by 2 only under fix_reference_bugs (the reference recomputes them,
    k3m_tpu/model/layers.py:303-310). `task_specific_tokens` inserts the
    row of `task_ids` of a 20-row `task_embeddings` table right after
    [CLS], before the LN, with no position or type embedding on it
    (k3m_tpu/model/layers.py:313-323): the output has L + 1 positions
    (one task token per row, as every reference use). Vocab-parallel under tensor
    parallelism (`tp` model ranks): the table holds rows vocab0 ..
    vocab0 + V / tp - 1, an id outside them looks up zeros, and the rows
    are summed over the model group (exact: one rank adds a row, the others
    zeros)."""
    tp = 1
    vocab0 = 0

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        if cfg.task_specific_tokens:
            self.task_embeddings = nn.Embedding(20, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, compute_dtype(cfg))

    def forward(self, input_ids, token_type_ids, deterministic: bool = True,
                task_ids=None):
        seq_len = input_ids.shape[1]
        pos_ids = torch.arange(seq_len, device=input_ids.device)
        if self.cfg.model == "roberta" and self.cfg.fix_reference_bugs:
            pos_ids = pos_ids + 2
        x = (self.word(input_ids)
             + self.position_embeddings(pos_ids)[None, :, :]
             + self.token_type_embeddings(token_type_ids))
        if self.cfg.task_specific_tokens:
            if task_ids is None:
                raise ValueError("task_specific_tokens=True requires task_ids (the "
                                 "reference crashes on task_ids=None too, "
                                 "vilbert_k3m.py:374)")
            t = self.task_embeddings(task_ids)
            if t.dim() == 2:                      # [B] ids: one task token
                t = t[:, None, :]
            x = torch.cat([x[:, :1], t, x[:, 1:]], dim=1)
        return dropout(self.LayerNorm(x), self.cfg.hidden_dropout_prob, deterministic)

    def word(self, input_ids):
        """The word embeddings of `input_ids`, from this rank's rows of the
        table under tensor parallelism."""
        if self.tp == 1:
            return self.word_embeddings(input_ids)
        local = input_ids - self.vocab0
        inside = (local >= 0) & (local < self.word_embeddings.weight.shape[0])
        rows = F.embedding(torch.where(inside, local, torch.zeros_like(local)),
                           self.word_embeddings.weight)
        rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        return dist.reduce_from_model(rows, self.tp)


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


class HeadParallel:
    """How an attention site's `num_heads` lie over its `tp` model ranks
    (train/mesh.py `shard_model` sets `tp` and `model_rank`). Its Q/K/V
    Linears are column-parallel: this rank holds columns model_rank * w ..
    (model_rank + 1) * w - 1, w = width / tp, of each. Where tp divides the
    heads those columns are whole heads, and the rank runs heads head0 ..
    head0 + num_heads / tp - 1. Where it does not (the 12 text heads at
    --n_model 8), each rank gathers the Q/K/V columns over the model group
    and runs every head with head0 0 (its Philox masks are one process's),
    and the row-parallel output Linear takes this rank's columns of the
    replicated context: the JAX package's replicated attention over the
    model axis (k3m_tpu/kernels/attention.py:227-230, coattn.py:77-79)."""
    tp = 1
    model_rank = 0

    @property
    def replicated(self) -> bool:
        return self.num_heads % self.tp != 0

    @property
    def head0(self) -> int:
        return 0 if self.replicated else self.model_rank * (self.num_heads // self.tp)

    @property
    def run_heads(self) -> int:
        """The heads this rank's kernel call runs."""
        return self.num_heads if self.replicated else self.num_heads // self.tp

    def gather_heads(self, t):
        """A Q/K/V projection's columns that this rank's heads read."""
        return dist.gather_from_model(t, self.tp) if self.replicated else t

    def own_columns(self, ctx):
        """This rank's columns of a context [B, L, width] for the row-parallel
        output Linear: all of it where the rank ran only its own heads."""
        if not self.replicated:
            return ctx
        w = ctx.shape[-1] // self.tp
        return ctx[..., self.model_rank * w:(self.model_rank + 1) * w]


class SelfAttention(HeadParallel, nn.Module):
    """Multi-head self-attention (ref BertSelfAttention:411). With `gated`
    it also holds the image stream's dynamic-attention projections
    `dyLinear_q`/`dyLinear_k` (ref :572-601), which ImageLayer applies.
    Under tensor parallelism see HeadParallel; the replicated gates are
    sliced to this rank's columns. Under `config.visualization` it runs
    `unfused_attention` and records its probabilities
    (`attention_probs`, model/visualize.py), one map per stream.

    `x` is one [B, L, hidden] stream, or `Packed` rows of several streams
    (`bias` then a tuple, one per stream; no gates): Q/K/V are projected
    once over all the rows and each stream attends over its own [B, L_i,
    H, D] views at its row offset; the contexts come back packed. Under
    `fused_qkv` the three projections are one (`fused_dense`), and q/k/v
    are views at row stride 3 * hidden of its output (under tensor
    parallelism 3 * the rank's columns; where the heads do not divide the
    model ranks each of Q/K/V is gathered apart)."""

    def __init__(self, cfg: K3MConfig, hidden: int, num_heads: int,
                 attn_dropout: float, gated: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.attn_dropout = attn_dropout
        self.visualization = cfg.visualization
        self.fused_qkv = cfg.fused_qkv
        self.query = Linear(hidden, hidden)
        self.key = Linear(hidden, hidden)
        self.value = Linear(hidden, hidden)
        if gated:
            self.dyLinear_q = Linear(cfg.hidden_size, hidden)
            self.dyLinear_k = Linear(cfg.hidden_size, hidden)

    def forward(self, x, bias, gate_q=None, gate_k=None, deterministic: bool = True):
        packed = isinstance(x, Packed)
        rows = dist.copy_to_model(x.rows if packed else x, self.tp)
        if self.fused_qkv:
            q, k, v = fused_dense(rows, (self.query, self.key, self.value))
        else:
            q, k, v = self.query(rows), self.key(rows), self.value(rows)
        if packed:
            if gate_q is not None or gate_k is not None:
                raise ValueError("QK gating is single-stream (image layers)")
            streams = zip(*(unpack_rows(self.gather_heads(t), x.shapes) for t in (q, k, v)),
                          bias)
            return Packed.pack([self._attend(*s, deterministic) for s in streams])
        if gate_q is not None:
            q = q * self.local_columns(gate_q)[:, None, :]
        if gate_k is not None:
            k = k * self.local_columns(gate_k)[:, None, :]
        return self._attend(*(self.gather_heads(t) for t in (q, k, v)), bias, deterministic)

    def _attend(self, q, k, v, bias, deterministic):
        """The context [B, L, width] of one stream's projections [B, L, *]."""
        h = self.run_heads
        q, k, v = (split_heads(t, h) for t in (q, k, v))
        if self.visualization:
            ctx, probs = unfused_attention(q, k, v, bias, self.attn_dropout, deterministic)
            visualize.record(self, "attention_probs", probs)
        else:
            ctx = attention_core(q, k, v, bias, self.attn_dropout, deterministic,
                                 self.head0, self.num_heads)
        return self.own_columns(merge_heads(ctx))

    def local_columns(self, gate):
        """This rank's columns of a replicated [B, hidden] gate."""
        if self.tp == 1:
            return gate
        width = gate.shape[-1] // self.tp
        c0 = self.model_rank * width
        return dist.copy_to_model(gate, self.tp)[:, c0:c0 + width]


class Attention(nn.Module):
    """`self` attention + `output` projection/LN (ref BertAttention)."""

    def __init__(self, cfg: K3MConfig, hidden: int, num_heads: int,
                 attn_dropout: float, gated: bool = False):
        super().__init__()
        self.self = SelfAttention(cfg, hidden, num_heads, attn_dropout, gated)
        self.output = DenseLayerNorm(hidden, hidden, compute_dtype(cfg))


class TextLayer(nn.Module):
    """BertLayer: self-attention + output + FFN, post-LN (ref :535-548).
    `x` may be `Packed` rows of several streams (`bias` a tuple): the
    attention-out Linear, its dropout and LN, and the FFN then run once
    over all the rows, which stay packed (k3m_tpu/model/layers.py:425-462)."""

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
        packed = isinstance(x, Packed)
        rows, shapes = (x.rows, x.shapes) if packed else (x, None)
        ctx = self.attention.self(x, bias, deterministic=det)
        a = self.attention.output(ctx.rows if packed else ctx, rows, self.rate, det, shapes)
        out = self.output(self.act(self.intermediate(a)), a, self.rate, det, shapes)
        return Packed(out, shapes) if packed else out


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
