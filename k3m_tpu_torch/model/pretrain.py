"""Shared K3M trunk: embeddings -> tri-stream encoder -> fusion -> c_initial.

Port of `K3MTrunk` (k3m_tpu/model/pretrain.py:57-139; reference bert_tri
:2507-2671 + get_sequence_pooled_output_final :2376-2411 + c_initial
:2721-2725). `K3MForPretraining` and its losses come with the training
slice.
"""

from __future__ import annotations

import torch
from torch import nn

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.model.encoder import TriStreamEncoder
from k3m_tpu_torch.model.fusion import FusionBlock
from k3m_tpu_torch.model.layers import (
    BertEmbeddings, ImageEmbeddings, adopt, compute_dtype, mask_to_bias,
)


def check_deterministic(deterministic: bool) -> None:
    if not deterministic:
        raise NotImplementedError(
            "deterministic=False (dropout, Gumbel draws) is not ported yet")


class K3MTrunk(nn.Module):
    """Its parameters carry the reference's top-level names
    (`embeddings.*`, `v_embeddings.*`, `encoder.*`, `score_*`,
    `map_bi_to_individual`)."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        if cfg.use_image:
            self.v_embeddings = ImageEmbeddings(cfg)
        self.encoder = TriStreamEncoder(cfg)
        adopt(self, "fusion", FusionBlock(cfg))

    def forward(self, input_ids, image_feat, image_loc, token_type_ids,
                attention_mask, image_attention_mask, input_ids_pv,
                token_type_ids_pv, attention_mask_pv, *,
                deterministic: bool = True, gumbel_noise=None):
        check_deterministic(deterministic)
        cfg = self.cfg
        dt = compute_dtype(cfg)
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if attention_mask_pv is None:
            attention_mask_pv = torch.ones_like(input_ids_pv)
        if token_type_ids_pv is None:
            token_type_ids_pv = torch.zeros_like(input_ids_pv)

        txt_bias = mask_to_bias(attention_mask)
        pv_bias = mask_to_bias(attention_mask_pv)
        txt_mask2 = attention_mask.to(dt)[:, :, None]
        pv_mask2 = attention_mask_pv.to(dt)[:, :, None]
        txt_emb = self.embeddings(input_ids, token_type_ids)
        pv_emb = self.embeddings(input_ids_pv, token_type_ids_pv)

        img_emb = img_bias = None
        if cfg.use_image:
            if image_attention_mask is None:
                image_attention_mask = torch.ones(image_feat.shape[:2],
                                                  device=image_feat.device)
            img_bias = mask_to_bias(image_attention_mask)
            img_emb = self.v_embeddings(image_feat, image_loc)

        (t_with_v, v_with_t, pv_with_v, v_with_pv,
         t_with_pv, pv_with_t) = self.encoder(
            txt_emb, img_emb, txt_bias, txt_mask2, img_bias,
            pv_emb, pv_bias, pv_mask2)

        seq_v, seq_t, seq_pv, pooled_v, pooled_t, pooled_pv = self.fusion(
            t_with_v, v_with_t, pv_with_v, v_with_pv, t_with_pv, pv_with_t,
            txt_emb, pv_emb, img_emb, deterministic=deterministic,
            gumbel_noise=gumbel_noise)

        if pooled_v is not None:
            c_initial = (pooled_v + pooled_t + pooled_pv) / 3.0
        else:
            c_initial = (pooled_t + pooled_pv) / 2.0
        return dict(seq_v=seq_v, seq_t=seq_t, seq_pv=seq_pv,
                    pooled_v=pooled_v, pooled_t=pooled_t, pooled_pv=pooled_pv,
                    c_initial=c_initial)
