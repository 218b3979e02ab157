"""K3M item-alignment model (twin tower).

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
Each loss is a mean over the pairs of the global batch: under data
parallelism (`world=`, k3m_tpu_torch/dist.py) the rank's sum over the global count.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import K3MConfig
from .device import resolve_device
from . import rand as k3m_random
from .heads import ClassificationHead
from .layers import (
    adopt, cast_linears, compute_dtype, init_weights, set_compute_dtype,
)
from .pretrain import K3MTrunk
from .structure import StructureAggregator
from . import dist


def pair_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of the per-pair terms `x` [B] over the global batch (in a world
    of one the bits of `x.mean()`, on the CPU and on the card alike)."""
    return x.sum() / dist.window(x.shape[0])[1]


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
                                    item["index_p"], item["index_v"],
                                    deterministic=deterministic)
        return out["c_initial"], c_final

    def forward(self, labels, item1, item2, *, deterministic: bool = True,
                rng: Optional[k3m_random.StepRandom] = None,
                world: Optional[dist.World] = None):
        """(emb1, emb2, probs, loss); training draws from `rng`; `world`:
        the ranks whose pairs make the global batch (none: these pairs are
        the global batch)."""
        with k3m_random.use(rng), dist.use(world, labels.shape[0]):
            return self._forward(labels, item1, item2, deterministic)

    def _forward(self, labels, item1, item2, deterministic: bool):
        cfg = self.cfg
        _, emb1 = self.item_embedding(item1, deterministic=deterministic)
        _, emb2 = self.item_embedding(item2, deterministic=deterministic)
        labels_f = labels.float()
        if cfg.loss_type == "inner":
            logits = (emb1.float() * emb2.float()).sum(-1)
            loss = pair_mean(torch.clamp(logits, min=0) - logits * labels_f
                             + torch.log1p(torch.exp(-logits.abs())))
            probs = torch.sigmoid(logits)
        elif cfg.loss_type == "cosine":
            cos12 = cosine_similarity(emb1, emb2)
            target = 2.0 * labels_f - 1.0
            loss = pair_mean(torch.where(target > 0, 1.0 - cos12, torch.relu(cos12)))
            if cfg.fix_reference_bugs:
                probs = (cos12 + 1.0) / 2.0
            else:
                probs = (cosine_similarity(emb1, emb1) + 1.0) / 2.0   # ref :3443
        else:
            logits = self.classifier(torch.cat([emb1, emb2], dim=1),
                                     deterministic=deterministic)
            logp = F.log_softmax(logits, dim=-1)
            loss = pair_mean(-logp.gather(1, labels.long()[:, None])[:, 0])
            probs_full = torch.softmax(logits, dim=-1)
            emb1, emb2 = probs_full[:, 0], probs_full[:, 1]
            probs = probs_full[:, 1]
        return emb1, emb2, probs, loss


def build_model(cfg: K3MConfig, *, seed: int = 42, device="cuda",
                train: bool = False) -> K3MForItemAlignment:
    """K3MForItemAlignment with random weights from `seed`, on `device`.
    For serving (the default) its Linear weights are cast to the compute
    dtype once and it is in eval mode; for training its parameters stay
    fp32 and each Linear casts to the compute dtype at each use, as in
    pretraining."""
    dev = resolve_device(device)
    model = init_weights(K3MForItemAlignment(cfg), seed, cfg.initializer_range)
    model.to(dev)
    if train:
        return model.train()
    cast_linears(model, compute_dtype(cfg))
    return model.eval()
