"""Prediction heads (port of k3m_tpu/model/heads.py; reference
vilbert_k3m/vilbert_k3m.py:1783-1912, 2164-2183).

Module names are the reference torch names (`cls.predictions.transform.
dense`, `cls.predictions.bias`, `cls.imagePredictions.decoder`,
`cls.seq_relationship`); the MLM decoder is tied to the word-embedding
`Parameter` and has no weight of its own (the reference's
`cls.predictions.decoder.weight` is an alias of the table).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.model.layers import (
    LayerNorm, Linear, act_fn, compute_dtype, dropout,
)


def _chunk_nll(xi, li, table, bias, ignore_index: int):
    """(sum of nll over valid labels, count) of one sequence chunk."""
    logits = torch.matmul(xi, table.t()).to(xi.dtype) + bias.to(xi.dtype)
    valid = li != ignore_index
    safe = torch.where(valid, li, torch.zeros_like(li))
    lse = torch.logsumexp(logits.float(), dim=-1)
    # the label logit from a row gather of the table, not from the logits;
    # F.embedding's backward sums the many rows that ignored labels send to
    # row 0 without the serialised scatter of an index_put backward
    label_logit = ((xi.float() * F.embedding(safe, table).float()).sum(-1)
                   + F.embedding(safe, bias[:, None])[..., 0])
    nll = lse - label_logit
    return torch.where(valid, nll, torch.zeros_like(nll)).sum(), valid.sum()


def chunked_masked_ce(x, table, bias, labels, chunk: int,
                      ignore_index: int = -1) -> torch.Tensor:
    """Mean CE(ignore -1) over vocab logits `x @ table.T + bias`
    (k3m_tpu/model/heads.py:39-92): the sequence is cut in chunks of
    `chunk` (the last one padded), and each chunk runs under
    torch.utils.checkpoint, so its [B, chunk, vocab] logits are recomputed
    in the backward instead of saved. Logits are stored in x's dtype and
    reduced in fp32, as in the JAX package."""
    B, L, _ = x.shape
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=ignore_index)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, L + pad, chunk):
        s, c = checkpoint(_chunk_nll, x[:, i:i + chunk], labels[:, i:i + chunk],
                          table, bias, ignore_index, use_reentrant=False)
        total = total + s
        count = count + c
    return total / torch.clamp(count, min=1)


class _Transform(nn.Module):
    """dense -> hidden_act -> LayerNorm (BertPredictionHeadTransform)."""

    def __init__(self, cfg: K3MConfig, size: int):
        super().__init__()
        self.dense = Linear(size, size)
        self.act = act_fn(cfg.hidden_act)
        self.LayerNorm = LayerNorm(size, compute_dtype(cfg))

    def forward(self, x):
        return self.LayerNorm(self.act(self.dense(x)))


class LMPredictionHead(nn.Module):
    """MLM head: transform, then the tied word table plus an output-only
    bias; returns the mean masked CE over `labels` (chunked_masked_ce), so
    the [B, L, vocab] logits never exist."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.cfg = cfg
        self.transform = _Transform(cfg, cfg.hidden_size)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, hidden_states, word_embedding_table, labels):
        table = word_embedding_table.to(compute_dtype(self.cfg))
        return chunked_masked_ce(self.transform(hidden_states), table, self.bias,
                                 labels, self.cfg.ce_chunk)


class ImagePredictionHead(nn.Module):
    """Masked-RoI head: transform (hidden_act, as the reference,
    :1806-1811) then decode to v_target_size, returned in fp32."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.transform = _Transform(cfg, cfg.v_hidden_size)
        self.decoder = Linear(cfg.v_hidden_size, cfg.v_target_size)

    def forward(self, hidden_states):
        return self.decoder(self.transform(hidden_states)).float()


class PreTrainingHeads(nn.Module):
    """MLM for title and pv (one shared head), masked-RoI scores, and the
    alignment score of the summed pooled outputs, dropped at the
    reference's hard-coded 0.1 in training (heads.py:163)."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.use_image = cfg.use_image
        self.predictions = LMPredictionHead(cfg)
        self.seq_relationship = Linear(cfg.hidden_size, 2)
        if cfg.use_image:
            self.imagePredictions = ImagePredictionHead(cfg)

    def forward(self, sequence_output_t, sequence_output_v, pooled_output_t,
                pooled_output_v, sequence_output_pv, pooled_output_pv,
                word_embedding_table, lm_labels_t, lm_labels_pv, *,
                deterministic: bool = True):
        """(MLM loss of the title, RoI scores, MLM loss of the pv, alignment
        logits fp32)."""
        pooled = pooled_output_t + pooled_output_pv
        if pooled_output_v is not None:
            pooled = pooled + pooled_output_v
        pooled = dropout(pooled, 0.1, deterministic)
        seq_relationship = self.seq_relationship(pooled).float()
        scores_t = self.predictions(sequence_output_t, word_embedding_table, lm_labels_t)
        scores_pv = self.predictions(sequence_output_pv, word_embedding_table, lm_labels_pv)
        scores_v = None
        if self.use_image and sequence_output_v is not None:
            scores_v = self.imagePredictions(sequence_output_v)
        return scores_t, scores_v, scores_pv, seq_relationship


class ClassificationHead(nn.Module):
    """Item-alignment CE head (ref :2164-2183): Dense(h) -> tanh ->
    Dense(2), over the concat of the two item embeddings. Dropout is
    inference-inactive."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.dense = Linear(2 * cfg.hidden_size, cfg.hidden_size)
        self.out_proj = Linear(cfg.hidden_size, 2)

    def forward(self, features):
        x = torch.tanh(self.dense(features.to(self.dtype)))
        return self.out_proj(x).float()
