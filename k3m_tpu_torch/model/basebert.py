"""Single-stream VisualBERT-style baseline.

Port of k3m_tpu/model/basebert.py (reference vilbert_k3m/basebert.py:
`BertModel`:659, `BertForMultiModalPreTraining`:777,
`BaseBertForVLTasks`:893): text tokens and image RoIs are embedded into
ONE stream and the plain BERT stack (the port's `TextLayer`, so its
attention and LayerNorm run through the port's kernels on the card) runs
over the concatenation, with the concatenated key bias. As in the JAX
package:
  * image tokens get token type 1 (ref :342-352), from the image
    embeddings' own type table;
  * the single stream needs v_hidden_size == hidden_size (raised here);
  * the MLM decoder is tied to the word table; the image head decodes to
    `v_target_size` (1601) classes with an untied Linear (ref :622-634);
  * masked-image loss = KLDiv against the soft labels over the rows with
    image_label == 1 (ref :869-877); MLM and alignment by CE with
    ignore_index -1;
  * `SimpleClassifier` (ref :966-978) is Linear-ReLU-Dropout-Linear: the
    reference's weight_norm reparametrization is plain weights here, as in
    the JAX package (`main.0` and `main.3`, the reference's Sequential
    indices).

Parameter names follow the reference's modules: `bert.embeddings.*`,
`bert.v_embeddings.*`, `bert.encoder.layer.N.*`, `bert.pooler.dense`,
`cls.predictions.*`, `cls.imagePredictions.*`, `cls.seq_relationship`,
and the task heads' `vil_prediction`, `vil_logit`, `vision_logit`,
`linguistic_logit` (`convert.from_jax_params` carries the JAX tree).
The task heads' Linears compute in fp32, as the JAX package's Dense
without a dtype does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from k3m_tpu_torch import dist
from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.model import random as k3m_random
from k3m_tpu_torch.model.layers import (
    BertEmbeddings, LayerNorm, Linear, TextLayer, act_fn, compute_dtype, dropout,
    mask_to_bias, set_compute_dtype,
)
from k3m_tpu_torch.model.pretrain import cross_entropy_ignore


class BaseImageEmbeddings(nn.Module):
    """Feature + location projections plus the type-1 row of the image
    embeddings' own token-type table, LN, dropout (ref BertImageEmbeddings,
    basebert.py:324-352)."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.rate = cfg.hidden_dropout_prob
        self.image_embeddings = Linear(cfg.v_feature_size, cfg.v_hidden_size)
        self.image_location_embeddings = Linear(5, cfg.v_hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.v_hidden_size)
        self.LayerNorm = LayerNorm(cfg.v_hidden_size, self.dtype)

    def forward(self, image_feat, image_loc, deterministic: bool = True):
        x = (self.image_embeddings(image_feat.to(self.dtype))
             + self.image_location_embeddings(image_loc.to(self.dtype))
             + self.token_type_embeddings.weight[1].to(self.dtype))
        return dropout(self.LayerNorm(x), self.rate, deterministic)


class Pooler(nn.Module):
    """tanh(dense(x[:, 0])) (ref BertPooler:507-519)."""

    def __init__(self, hidden: int):
        super().__init__()
        self.dense = Linear(hidden, hidden)

    def forward(self, x):
        return torch.tanh(self.dense(x[:, 0]))


class Encoder(nn.Module):
    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.layer = nn.ModuleList(TextLayer(cfg) for _ in range(cfg.num_hidden_layers))


class SingleStreamModel(nn.Module):
    """Text + image tokens through one BERT stack (ref BertModel:659-776):
    returns (sequence [B, Lt + Lv, H], pooled [B, H], the word table)."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        if cfg.v_hidden_size != cfg.hidden_size:
            raise ValueError(f"the single-stream model needs v_hidden_size == hidden_size "
                             f"(got {cfg.v_hidden_size} and {cfg.hidden_size})")
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.v_embeddings = BaseImageEmbeddings(cfg)
        self.encoder = Encoder(cfg)
        self.pooler = Pooler(cfg.hidden_size)

    def forward(self, input_ids, image_feat, image_loc, token_type_ids=None,
                attention_mask=None, image_attention_mask=None, deterministic: bool = True):
        B, Lt = input_ids.shape
        Lv = image_feat.shape[1]
        dev = input_ids.device
        if token_type_ids is None:
            token_type_ids = torch.zeros((B, Lt), dtype=torch.long, device=dev)
        if attention_mask is None:
            attention_mask = torch.ones((B, Lt), dtype=torch.long, device=dev)
        if image_attention_mask is None:
            image_attention_mask = torch.ones((B, Lv), dtype=torch.long, device=dev)
        txt = self.embeddings(input_ids, token_type_ids, deterministic)
        img = self.v_embeddings(image_feat, image_loc, deterministic)
        x = torch.cat([txt, img.to(txt.dtype)], dim=1)
        bias = torch.cat([mask_to_bias(attention_mask), mask_to_bias(image_attention_mask)],
                         dim=-1)
        for layer in self.encoder.layer:
            x = layer(x, bias, deterministic)
        return x, self.pooler(x), self.embeddings.word_embeddings.weight


class HeadTransform(nn.Module):
    """Dense + activation + LN of a prediction head (ref :522-540)."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.act = act_fn(cfg.hidden_act)
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, compute_dtype(cfg))

    def forward(self, x):
        return self.LayerNorm(self.act(self.dense(x)))


class LMPrediction(nn.Module):
    """The MLM head: its decoder is the tied word table, plus `bias`."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.transform = HeadTransform(cfg)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))


class ImagePrediction(nn.Module):
    """The image head: an untied decoder to v_target_size classes."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.transform = HeadTransform(cfg)
        self.decoder = Linear(cfg.hidden_size, cfg.v_target_size)


class SingleStreamPreTrainingHeads(nn.Module):
    """Tied MLM head, 2-way alignment, image head (ref :637-657): fp32
    (text scores [B, Lt, V], image scores [B, Lv, v_target_size], the
    alignment pair [B, 2])."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.predictions = LMPrediction(cfg)
        self.imagePredictions = ImagePrediction(cfg)
        self.seq_relationship = Linear(cfg.hidden_size, 2)

    def forward(self, seq_t, seq_v, pooled, word_table):
        h = self.predictions.transform(seq_t)
        scores_t = h.float() @ word_table.float().t() + self.predictions.bias
        ip = self.imagePredictions
        scores_v = ip.decoder(ip.transform(seq_v))
        return scores_t, scores_v.float(), self.seq_relationship(pooled).float()


def masked_image_kl(scores_v, image_target, image_label):
    """KLDiv(log_softmax(scores), target) summed over classes, averaged over
    the rows with image_label == 1 (ref :869-877): torch's KLDiv keeps the
    target's t log t term."""
    t = image_target.float()
    kl = -(t * F.log_softmax(scores_v, dim=-1)).sum(-1)
    kl = kl + torch.where(t > 0, t * torch.log(torch.where(t > 0, t, torch.ones_like(t))),
                          torch.zeros_like(t)).sum(-1)
    w = (image_label == 1).float()
    return (kl * w).sum() / torch.clamp(w.sum(), min=1e-9)


class BaseBertForPretraining(nn.Module):
    """Single-stream pretraining (ref BertForMultiModalPreTraining:777-891):
    (masked_lm_loss, masked_img_loss, next_sentence_loss), or the three
    score tensors without the labels."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = SingleStreamModel(cfg)
        self.cls = SingleStreamPreTrainingHeads(cfg)
        set_compute_dtype(self, compute_dtype(cfg))

    def forward(self, input_ids, image_feat, image_target, image_loc, token_type_ids=None,
                attention_mask=None, image_attention_mask=None, masked_lm_labels=None,
                image_label=None, next_sentence_label=None, *, deterministic: bool = True,
                rng: Optional[k3m_random.StepRandom] = None):
        """Training (`deterministic=False`) draws its dropout from `rng`."""
        with k3m_random.use(rng), dist.use(None, input_ids.shape[0]):
            Lt = input_ids.shape[1]
            seq, pooled, table = self.bert(input_ids, image_feat, image_loc, token_type_ids,
                                           attention_mask, image_attention_mask,
                                           deterministic)
            scores_t, scores_v, seq_rel = self.cls(seq[:, :Lt], seq[:, Lt:], pooled, table)
            if masked_lm_labels is None or next_sentence_label is None:
                return scores_t, scores_v, seq_rel
            # row 0 of the image tokens is the global image token (ref :871)
            img = masked_image_kl(scores_v[:, 1:], image_target, image_label)
            lm = cross_entropy_ignore(scores_t.reshape(-1, self.cfg.vocab_size),
                                      masked_lm_labels.reshape(-1))
            nsp = cross_entropy_ignore(seq_rel.reshape(-1, 2), next_sentence_label.reshape(-1))
            return lm, img, nsp


class SimpleClassifier(nn.Module):
    """Linear-ReLU-Dropout-Linear (ref :966-978), in fp32."""

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int, rate: float = 0.5):
        super().__init__()
        self.rate = rate
        self.main = nn.ModuleDict({"0": Linear(in_dim, hid_dim), "3": Linear(hid_dim, out_dim)})

    def forward(self, x, deterministic: bool = True):
        h = dropout(F.relu(self.main["0"](x.float())), self.rate, deterministic)
        return self.main["3"](h)


class BaseBertForVLTasks(nn.Module):
    """Task-head bundle over the single-stream trunk (ref :893-963):
    (vil_prediction, vil_logit, vil_binary, vision_pred, vision_logit,
    ling_pred, linguistic_logit)."""

    def __init__(self, cfg: K3MConfig, num_labels: int, dropout_prob: float = 0.1):
        super().__init__()
        self.cfg = cfg
        self.dropout_prob = dropout_prob
        self.bert = SingleStreamModel(cfg)
        self.cls = SingleStreamPreTrainingHeads(cfg)
        self.vil_prediction = SimpleClassifier(cfg.hidden_size, cfg.hidden_size * 2,
                                               num_labels, 0.5)
        self.vil_logit = Linear(cfg.hidden_size, 1)
        self.vision_logit = Linear(cfg.v_hidden_size, 1)
        self.linguistic_logit = Linear(cfg.hidden_size, 1)
        set_compute_dtype(self, compute_dtype(cfg))
        for head in (self.vil_prediction, self.vil_logit, self.vision_logit,
                     self.linguistic_logit):
            set_compute_dtype(head, torch.float32)

    def forward(self, input_ids, image_feat, image_loc, token_type_ids=None,
                attention_mask=None, image_attention_mask=None, *,
                deterministic: bool = True, rng: Optional[k3m_random.StepRandom] = None):
        B, Lt = input_ids.shape
        if image_attention_mask is None:
            image_attention_mask = torch.ones(image_feat.shape[:2], dtype=torch.long,
                                              device=image_feat.device)
        det = deterministic
        with k3m_random.use(rng), dist.use(None, B):
            seq, pooled, table = self.bert(input_ids, image_feat, image_loc, token_type_ids,
                                           attention_mask, image_attention_mask, det)
            seq_t, seq_v = seq[:, :Lt], seq[:, Lt:]
            ling_pred, vision_pred, vil_binary = self.cls(seq_t, seq_v, pooled, table)
            vil_prediction = self.vil_prediction(pooled, det)
            vil_logit = self.vil_logit(pooled.float())
            drop_v = dropout(seq_v.float(), self.dropout_prob, det)
            drop_t = dropout(seq_t.float(), self.dropout_prob, det)
            vision_logit = self.vision_logit(drop_v) + (
                (1.0 - image_attention_mask.float()) * -10000.0)[:, :, None]
            linguistic_logit = self.linguistic_logit(drop_t)
        return (vil_prediction, vil_logit, vil_binary, vision_pred, vision_logit,
                ling_pred, linguistic_logit)
