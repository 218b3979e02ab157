"""K3M item-alignment model (twin tower), inference forward.

Port of k3m_tpu/model/alignment.py (reference K3MForItemAlignment,
vilbert_k3m/vilbert_k3m.py:2862-3454). Each item runs the same trunk and
the structure aggregator without LPM; the two item embeddings are then
compared by `loss_type`:
  "inner":  BCE with logits over inner products; probs = sigmoid
  "cosine": CosineEmbeddingLoss(margin=0) with targets 2y-1; probs from
            cosine(item1, item1) as the reference has it, or
            cosine(item1, item2) under fix_reference_bugs
  "ce":     ClassificationHead over the concat + CE; emb1/emb2 become the
            two class probabilities (ref :3448-3449)
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.device import resolve_device
from k3m_tpu_torch.model.heads import ClassificationHead
from k3m_tpu_torch.model.layers import (
    adopt, cast_linears, compute_dtype, init_weights, set_compute_dtype,
)
from k3m_tpu_torch.model.pretrain import K3MTrunk
from k3m_tpu_torch.model.structure import StructureAggregator


def cosine_similarity(a, b, eps: float = 1e-8):
    a, b = a.float(), b.float()
    na = torch.clamp(torch.linalg.vector_norm(a, dim=-1), min=eps)
    nb = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=eps)
    return (a * b).sum(-1) / (na * nb)


class K3MForItemAlignment(nn.Module):
    def __init__(self, cfg: K3MConfig):
        super().__init__()
        if cfg.loss_type not in ("inner", "cosine", "ce"):
            raise ValueError(f"unsupported loss_type {cfg.loss_type}")
        self.cfg = cfg
        adopt(self, "trunk", K3MTrunk(cfg))
        adopt(self, "structure", StructureAggregator(cfg, with_lpm=False))
        if cfg.loss_type == "ce":
            self.classifier = ClassificationHead(cfg)
        set_compute_dtype(self, compute_dtype(cfg))

    def item_embedding(self, item: Dict[str, torch.Tensor], *,
                       deterministic: bool = True):
        """ref item_embedding :3329-3377 — returns (c_initial, c_final)."""
        out = self.trunk(
            item["input_ids"], item.get("image_feat"), item.get("image_loc"),
            item.get("segment_ids"), item.get("input_mask"),
            item.get("image_mask"), item["input_ids_pv"],
            item.get("segment_ids_pv"), item.get("input_mask_pv"),
            deterministic=deterministic)
        c_final, _ = self.structure(out["c_initial"], out["seq_pv"],
                                    item["index_p"], item["index_v"])
        return out["c_initial"], c_final

    def forward(self, labels, item1, item2, *, deterministic: bool = True):
        if not deterministic:
            raise NotImplementedError("training the alignment model (--do_train) "
                                      "is not ported yet")
        cfg = self.cfg
        _, emb1 = self.item_embedding(item1)
        _, emb2 = self.item_embedding(item2)
        labels_f = labels.float()
        if cfg.loss_type == "inner":
            logits = (emb1.float() * emb2.float()).sum(-1)
            loss = torch.mean(torch.clamp(logits, min=0) - logits * labels_f
                              + torch.log1p(torch.exp(-logits.abs())))
            probs = torch.sigmoid(logits)
        elif cfg.loss_type == "cosine":
            cos12 = cosine_similarity(emb1, emb2)
            target = 2.0 * labels_f - 1.0
            loss = torch.mean(torch.where(target > 0, 1.0 - cos12, torch.relu(cos12)))
            if cfg.fix_reference_bugs:
                probs = (cos12 + 1.0) / 2.0
            else:
                probs = (cosine_similarity(emb1, emb1) + 1.0) / 2.0   # ref :3443
        else:
            logits = self.classifier(torch.cat([emb1, emb2], dim=1))
            logp = F.log_softmax(logits, dim=-1)
            loss = -logp.gather(1, labels.long()[:, None])[:, 0].mean()
            probs_full = torch.softmax(logits, dim=-1)
            emb1, emb2 = probs_full[:, 0], probs_full[:, 1]
            probs = probs_full[:, 1]
        return emb1, emb2, probs, loss


def build_model(cfg: K3MConfig, *, seed: int = 42, device="cuda") -> K3MForItemAlignment:
    """An eval-mode K3MForItemAlignment with random weights from `seed`, on
    `device`, its Linear layers in the compute dtype."""
    dev = resolve_device(device)
    model = init_weights(K3MForItemAlignment(cfg), seed, cfg.initializer_range)
    model.to(dev)
    cast_linears(model, compute_dtype(cfg))
    return model.eval()
