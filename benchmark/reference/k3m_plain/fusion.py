"""Modality fusion ("pre-sampling") strategies.

Port of k3m_tpu/model/fusion.py (reference pre_sampling_sequence /
pre_sampling_sequence_soft / get_sequence_pooled_output_final,
vilbert_k3m/vilbert_k3m.py:2274-2411). Each modality combines its
individual embedding with its two interactive outputs:

  if_pre_sampling == 0: mean of the three
  if_pre_sampling == 1: hard selection over three sigmoid scores; at
                        inference an argmax one-hot (the JAX package's
                        documented deviation from torch's eval-time Gumbel
                        draw); in training, or with injected noise, the
                        straight-through hard Gumbel-softmax
  if_pre_sampling == 2: soft sigmoid-weighted concat + projection
  else (3):             mean of the two interactive outputs

The score projections keep the reference's top-level names
(`score_self_t`, `map_bi_to_individual`, ...).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .config import K3MConfig
from . import rand as k3m_random
from .layers import Linear, adopt


def gumbel_noise_like(logits: torch.Tensor, generator: torch.Generator):
    """Gumbel(0, 1) noise as the JAX package draws it (fusion.py:40-42):
    -log(-log(u + 1e-20)) with u uniform in [1e-20, 1), drawn for the
    global batch (`rows_rand`)."""
    u = k3m_random.rows_rand(generator, logits.shape, logits.device)
    u = u * (1.0 - 1e-20) + 1e-20
    return -torch.log(-torch.log(u + 1e-20))


def gumbel_softmax_hard(logits: torch.Tensor, noise: torch.Tensor,
                        dim: int) -> torch.Tensor:
    """Straight-through hard Gumbel-softmax, tau = 1, with pre-drawn Gumbel
    `noise`: the forward value is the one-hot argmax, the gradient that of
    the soft sample (y_hard + y_soft - y_soft.detach(), evaluated in that
    order as in the JAX package)."""
    y_soft = torch.softmax(logits.float() + noise.float(), dim=dim)
    index = y_soft.argmax(dim=dim, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(dim, index, 1.0)
    return y_hard + y_soft - y_soft.detach()


class ModalityFusion(nn.Module):
    """Fusion for one modality. `size` is the working hidden size
    (bi_hidden_size for 'v', hidden_size for 't'/'pv'); `num_modes` is 3
    when the image stream is active, else 2."""

    def __init__(self, cfg: K3MConfig, size: int, num_modes: int, modality: str):
        super().__init__()
        self.strategy = cfg.if_pre_sampling
        self.modality = modality
        m = modality
        if self.strategy in (1, 2):
            n_in = size * num_modes
            self.add_module(f"score_self_{m}", Linear(n_in, size))
            if num_modes == 3:
                self.add_module(f"score_cross1_{m}", Linear(n_in, size))
            self.add_module(f"score_cross2_{m}", Linear(n_in, size))
        if self.strategy == 2:
            self.add_module(f"soft_{m}", Linear(3 * size, size))

    def _lin(self, name):
        return getattr(self, f"{name}_{self.modality}")

    def forward(self, individual, c1, c2, *, deterministic: bool = True,
                gumbel_noise: Optional[torch.Tensor] = None):
        if individual is None:
            return None
        if self.strategy == 0:
            return (individual + c1 + c2) / 3.0
        if self.strategy not in (1, 2):
            return (c1 + c2) / 2.0

        ind = torch.relu(individual)
        r1 = torch.relu(c1) if c1 is not None else None
        r2 = torch.relu(c2) if c2 is not None else None
        feats = torch.cat([f for f in (ind, r1, r2) if f is not None], dim=2)

        if self.strategy == 2:
            a_s = torch.sigmoid(self._lin("score_self")(feats))
            a_1 = torch.sigmoid(self._lin("score_cross1")(feats))
            a_2 = torch.sigmoid(self._lin("score_cross2")(feats))
            mixed = torch.cat([ind * a_s, r1 * a_1, r2 * a_2], dim=2)
            return self._lin("soft")(mixed)

        alphas = [torch.sigmoid(self._lin("score_self")(feats))[..., None, :]]
        if r1 is not None:
            alphas.append(torch.sigmoid(self._lin("score_cross1")(feats))[..., None, :])
        if r2 is not None:
            alphas.append(torch.sigmoid(self._lin("score_cross2")(feats))[..., None, :])
        ak = torch.cat(alphas, dim=2)                    # [B, L, n_opts, size]
        if gumbel_noise is not None:
            a_index = gumbel_softmax_hard(ak, gumbel_noise, dim=2)
        elif deterministic:
            index = ak.argmax(dim=2, keepdim=True)
            a_index = torch.zeros_like(ak).scatter_(2, index, 1.0)
        else:
            a_index = gumbel_softmax_hard(
                ak, gumbel_noise_like(ak, k3m_random.active().gumbel), dim=2)
        out = ind * a_index[:, :, 0, :]
        i = 1
        for r in (r1, r2):
            if r is not None:
                out = out + r * a_index[:, :, i, :]
                i += 1
        return out.to(individual.dtype)


class FusionBlock(nn.Module):
    """get_sequence_pooled_output_final (ref :2376-2411) for all
    modalities. Pooled outputs are the mean over tokens 1: (skipping the
    CLS/global token); the visual one is mapped bi_hidden -> hidden."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.use_image = cfg.use_image
        num_modes = 3 if cfg.use_image else 2
        if cfg.use_image:
            adopt(self, "fusion_v", ModalityFusion(cfg, cfg.bi_hidden_size, num_modes, "v"))
            self.map_bi_to_individual = Linear(cfg.bi_hidden_size, cfg.hidden_size)
        adopt(self, "fusion_t", ModalityFusion(cfg, cfg.hidden_size, num_modes, "t"))
        adopt(self, "fusion_pv", ModalityFusion(cfg, cfg.hidden_size, num_modes, "pv"))

    def forward(self, t_with_v, v_with_t, pv_with_v, v_with_pv, t_with_pv,
                pv_with_t, individual_txt, individual_pv, individual_v, *,
                deterministic: bool = True, gumbel_noise=None):
        gn = gumbel_noise or {}
        seq_v = pooled_v = None
        if self.use_image:
            seq_v = self.fusion_v(individual_v, v_with_t, v_with_pv,
                                  deterministic=deterministic,
                                  gumbel_noise=gn.get("v"))
        seq_t = self.fusion_t(individual_txt, t_with_v, t_with_pv,
                              deterministic=deterministic, gumbel_noise=gn.get("t"))
        seq_pv = self.fusion_pv(individual_pv, pv_with_v, pv_with_t,
                                deterministic=deterministic,
                                gumbel_noise=gn.get("pv"))
        if self.use_image:
            pooled_v = self.map_bi_to_individual(seq_v[:, 1:, :].mean(dim=1))
        pooled_t = seq_t[:, 1:, :].mean(dim=1)
        pooled_pv = seq_pv[:, 1:, :].mean(dim=1)
        return seq_v, seq_t, seq_pv, pooled_v, pooled_t, pooled_pv
