"""K3M pretraining model: tri-stream trunk + four pretraining losses.

Port of k3m_tpu/model/pretrain.py (reference
BertForMultiModalPreTraining_tri_stru, vilbert_k3m/vilbert_k3m.py:2186-2859):
embeddings -> tri-stream encoder -> fusion -> c_initial (`K3MTrunk`), then
the structure aggregator with its LPM loss, and the heads:

  masked_lm_loss      CE(ignore -1) over the title (chunked, tied decoder)
  masked_img_loss     visual_target 0: KL(soft labels || softmax) over the
                      masked regions / their count; 1: masked MSE; 2: NCE
                      with 70/30 across/in-batch negatives
  masked_lm_loss_pv   CE(ignore -1) over the pv text
  moe_balance_loss    DeepSeek-V2's sequence-wise balance loss, summed over
                      the MoE text layers (text_block "deepseek_v2" only;
                      model/deepseek.py)
  alignment loss      CE over the fused 2-way score with label
                      1 - 1 * ((is_next + is_next_pv_v + is_next_pv_t) == 0)
  loss_struc          the LPM margin ranking loss (structure.py)

Randomness the reference draws inside its forward (LPM negatives, Gumbel
noise, NCE indices) can be injected (`neg_entity_idx`, `neg_value_idx`,
`gumbel_noise`, `neg_image_idx`); otherwise it comes from the active
StepRandom in training (model/random.py), which `rng=` makes active.

Under data parallelism (`world=`, k3m_tpu_torch/dist.py) each loss is the sum over
the rank's rows divided by the global count, so that the ranks' losses add
up to the one-process loss of the global batch; the NCE negatives index the
gathered image targets, drawn over the global batch.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.device import resolve_device
from k3m_tpu_torch.model import deepseek
from k3m_tpu_torch.model import random as k3m_random
from k3m_tpu_torch.model.encoder import TriStreamEncoder
from k3m_tpu_torch.model.fusion import FusionBlock
from k3m_tpu_torch.model.heads import PreTrainingHeads
from k3m_tpu_torch.model.layers import (
    BertEmbeddings, ImageEmbeddings, adopt, compute_dtype, init_weights,
    mask_to_bias, set_compute_dtype,
)
from k3m_tpu_torch.model.structure import StructureAggregator
from k3m_tpu_torch import dist


class K3MTrunk(nn.Module):
    """Its parameters carry the reference's top-level names
    (`embeddings.*`, `v_embeddings.*`, `encoder.*`, `score_*`,
    `map_bi_to_individual`). Under `task_specific_tokens` it takes
    `task_ids` and both text streams gain the task token after [CLS]; each
    text mask gains a ones column PREPENDED, as the reference extends it
    (k3m_tpu/model/pretrain.py:84-93: not inserted at 1, so a padding mask
    shifts one slot late; replicated)."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = (deepseek.DeepSeekEmbeddings(cfg) if cfg.text_block == "deepseek_v2"
                           else BertEmbeddings(cfg))
        if cfg.use_image:
            self.v_embeddings = ImageEmbeddings(cfg)
        self.encoder = TriStreamEncoder(cfg)
        adopt(self, "fusion", FusionBlock(cfg))

    def forward(self, input_ids, image_feat, image_loc, token_type_ids,
                attention_mask, image_attention_mask, input_ids_pv,
                token_type_ids_pv, attention_mask_pv, *,
                deterministic: bool = True, gumbel_noise=None, task_ids=None):
        cfg = self.cfg
        det = deterministic
        dt = compute_dtype(cfg)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask_pv is None:
            attention_mask_pv = torch.ones_like(input_ids_pv)
        if token_type_ids_pv is None:
            token_type_ids_pv = torch.zeros_like(input_ids_pv)
        if cfg.task_specific_tokens:
            attention_mask = torch.cat([torch.ones_like(attention_mask[:, :1]),
                                        attention_mask], dim=1)
            attention_mask_pv = torch.cat([torch.ones_like(attention_mask_pv[:, :1]),
                                           attention_mask_pv], dim=1)

        txt_bias = mask_to_bias(attention_mask)
        pv_bias = mask_to_bias(attention_mask_pv)
        txt_mask2 = attention_mask.to(dt)[:, :, None]
        pv_mask2 = attention_mask_pv.to(dt)[:, :, None]
        txt_emb = self.embeddings(input_ids, token_type_ids, det, task_ids)
        pv_emb = self.embeddings(input_ids_pv, token_type_ids_pv, det, task_ids)

        img_emb = img_bias = None
        if cfg.use_image:
            if image_attention_mask is None:
                image_attention_mask = torch.ones(image_feat.shape[:2],
                                                  device=image_feat.device)
            img_bias = mask_to_bias(image_attention_mask)
            img_emb = self.v_embeddings(image_feat, image_loc, det)

        (t_with_v, v_with_t, pv_with_v, v_with_pv,
         t_with_pv, pv_with_t) = self.encoder(
            txt_emb, img_emb, txt_bias, txt_mask2, img_bias,
            pv_emb, pv_bias, pv_mask2, det)
        if t_with_pv.shape[0] != txt_emb.shape[0]:
            # the JAX package's FusionBlock fails here too (a TypeError from
            # its concatenation): the encoder made b x b (or broadcast) rows
            opts = " / ".join(f for f in ("in_batch_pairs", "fast_mode") if getattr(cfg, f))
            raise ValueError(
                f"{opts}: the encoder's {t_with_pv.shape[0]} rows do not meet the fusion "
                f"block's {txt_emb.shape[0]} embedding rows (a feature of the encoder; the "
                "JAX package's K3M models fail alike)")

        seq_v, seq_t, seq_pv, pooled_v, pooled_t, pooled_pv = self.fusion(
            t_with_v, v_with_t, pv_with_v, v_with_pv, t_with_pv, pv_with_t,
            txt_emb, pv_emb, img_emb, deterministic=det,
            gumbel_noise=gumbel_noise)

        if pooled_v is not None:
            c_initial = (pooled_v + pooled_t + pooled_pv) / 3.0
        else:
            c_initial = (pooled_t + pooled_pv) / 2.0
        return dict(seq_v=seq_v, seq_t=seq_t, seq_pv=seq_pv,
                    pooled_v=pooled_v, pooled_t=pooled_t, pooled_pv=pooled_pv,
                    c_initial=c_initial,
                    word_embedding_table=self.embeddings.word_embeddings.weight)


def cross_entropy_ignore(logits, labels, ignore_index: int = -1):
    """Mean CE over labels != ignore_index (of the global batch: the count
    is the world's); an all-ignored batch gives 0 (the JAX package's
    deviation from torch's NaN)."""
    logits = logits.float().reshape(-1, logits.shape[-1])
    labels = labels.reshape(-1).long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -F.log_softmax(logits, dim=-1).gather(1, safe[:, None])[:, 0]
    total = torch.where(valid, nll, torch.zeros_like(nll)).sum()
    return total / torch.clamp(dist.current().sum_counts(valid.sum()), min=1)


def _xlogy(t):
    return torch.where(t == 0, torch.zeros_like(t), t * torch.log(t))


def masked_image_loss(cfg: K3MConfig, prediction_scores_v, image_label,
                      image_target, *, deterministic: bool = True,
                      neg_index: Optional[torch.Tensor] = None):
    """visual_target-dependent masked-RoI loss (ref :2744-2813).
    `prediction_scores_v` excludes the global token ([:, 1:]); image_label
    [B, R] is 1 on masked regions. `neg_index` [B, R, N] (flat into B * R)
    injects the NCE negatives; else they are drawn, from the step's LPM
    generator in training. Counts are the global batch's (k3m_tpu_torch/dist.py)."""
    world = dist.current()
    target = image_target.float()
    scores = prediction_scores_v.float()
    masked = image_label == 1
    mf = masked.float()
    if cfg.visual_target == 1:
        err = (scores - target) ** 2
        return (err * mf[:, :, None]).sum() / torch.clamp(
            world.sum_counts((mf[:, :, None] * torch.ones_like(err)).sum()), min=1)
    if cfg.visual_target == 0:
        kl = _xlogy(target) - target * F.log_softmax(scores, dim=2)
        return (kl * mf[:, :, None]).sum() / torch.clamp(world.sum_counts(mf.sum()), min=1)
    B, R, _ = scores.shape
    dev = scores.device
    row0, total = dist.window(B)
    if neg_index is None:
        gen = (k3m_random.active().lpm if not deterministic
               else torch.Generator(device=dev).manual_seed(0))
        n_across = int(cfg.num_negative_image * 0.7)
        n_inside = int(cfg.num_negative_image * 0.3)
        rand = lambda hi, shape: k3m_random.rows_randint(gen, hi, shape, dev)
        ar_b = torch.arange(B, device=dev) + row0
        row = rand(max(total - 1, 1), (B, R, n_across))
        row = torch.where(row == ar_b[:, None, None], torch.full_like(row, total - 1), row)
        across = row * R + rand(R, (B, R, n_across))
        col = rand(max(R - 1, 1), (B, R, n_inside))
        col = torch.where(col == torch.arange(R, device=dev)[None, :, None],
                          torch.full_like(col, R - 1), col)
        inside = ar_b[:, None, None] * R + col
        neg_index = torch.cat([across, inside], dim=2)
    # the "across" rows index the global batch's targets (data, no gradient)
    negative = world.all_gather_rows(target).reshape(total * R, -1)[neg_index.long()]
    sample = torch.cat([target[:, :, None, :], negative], dim=2)
    score = torch.einsum("brnd,brd->brn", sample, scores)
    nll = -F.log_softmax(score, dim=-1)[..., 0]
    return torch.where(masked, nll, torch.zeros_like(nll)).sum() / torch.clamp(
        world.sum_counts(masked.sum()), min=1)


class K3MForPretraining(nn.Module):
    """The reference's pretraining loss tuple as a dict (pretrain.py:202-275)."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        if cfg.task_specific_tokens:
            raise ValueError(
                "task_specific_tokens is a trunk-level feature (use K3MTrunk with "
                "task_ids); the pretraining losses are undefined under the inserted "
                "token (the reference's own pretrain path crashes with it, "
                "vilbert_k3m.py:2817), and the JAX package refuses it alike")
        self.cfg = cfg
        adopt(self, "trunk", K3MTrunk(cfg))
        adopt(self, "structure", StructureAggregator(cfg, with_lpm=True))
        self.cls = PreTrainingHeads(cfg)
        set_compute_dtype(self, compute_dtype(cfg))

    def forward(self, batch: Dict[str, torch.Tensor], *,
                deterministic: bool = True,
                rng: Optional[k3m_random.StepRandom] = None,
                neg_entity_idx=None, neg_value_idx=None, gumbel_noise=None,
                neg_image_idx=None, world: Optional[dist.World] = None):
        """`world`: the ranks whose rows make the global batch (none: this
        batch is the global one)."""
        rows = batch["input_ids"].shape[0]
        with k3m_random.use(rng), dist.use(world, rows), deepseek.balance_loss() as balance:
            out = self._forward(batch, deterministic, neg_entity_idx,
                                neg_value_idx, gumbel_noise, neg_image_idx)
            total = deepseek.balance_total(balance, self.cfg.aux_loss_alpha, rows)
        if total is not None:
            out["moe_balance_loss"] = total
        return out

    def _forward(self, batch, det, neg_entity_idx, neg_value_idx, gumbel_noise,
                 neg_image_idx):
        cfg = self.cfg
        out = self.trunk(
            batch["input_ids"], batch.get("image_feat"), batch.get("image_loc"),
            batch.get("segment_ids"), batch.get("input_mask"),
            batch.get("image_mask"), batch["input_ids_pv"],
            batch.get("segment_ids_pv"), batch.get("input_mask_pv"),
            deterministic=det, gumbel_noise=gumbel_noise)
        c_final, loss_struc = self.structure(
            out["c_initial"], out["seq_pv"], batch["index_p"], batch["index_v"],
            deterministic=det, neg_entity_idx=neg_entity_idx,
            neg_value_idx=neg_value_idx)
        lm_t, scores_v, lm_pv, seq_rel = self.cls(
            out["seq_t"], out["seq_v"], out["pooled_t"], out["pooled_v"],
            out["seq_pv"], out["pooled_pv"], out["word_embedding_table"],
            batch["lm_label_ids"], batch["lm_label_ids_pv"], deterministic=det)
        if cfg.use_image:
            img_loss = masked_image_loss(cfg, scores_v[:, 1:], batch["image_label"],
                                         batch["image_target"], deterministic=det,
                                         neg_index=neg_image_idx)
        else:
            img_loss = torch.zeros((), device=c_final.device)
        align_label = 1 - 1 * ((batch["is_next"] + batch["is_next_pv_v"]
                                + batch["is_next_pv_t"]) == 0).long()
        align = cross_entropy_ignore(seq_rel[:, None, :], align_label[:, None])
        return dict(masked_lm_loss=lm_t, masked_img_loss=img_loss,
                    masked_lm_loss_pv=lm_pv, next_sentence_loss_t_v_pv=align,
                    loss_struc=loss_struc, c_initial=out["c_initial"],
                    c_final=c_final)


def build_pretraining_model(cfg: K3MConfig, *, seed: int = 42,
                            device="cuda") -> K3MForPretraining:
    """K3MForPretraining with random fp32 weights from `seed`, on `device`."""
    model = init_weights(K3MForPretraining(cfg), seed, cfg.initializer_range)
    return model.to(resolve_device(device))
