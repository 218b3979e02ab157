"""Prediction heads. Only the item-alignment `ClassificationHead` is
ported so far (k3m_tpu/model/heads.py:179); the pretraining heads come
with the training slice."""

from __future__ import annotations

import torch
from torch import nn

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.model.layers import compute_dtype


class ClassificationHead(nn.Module):
    """Item-alignment CE head (ref :2164-2183): Dense(h) -> tanh ->
    Dense(2), over the concat of the two item embeddings. Dropout is
    inference-inactive."""

    def __init__(self, cfg: K3MConfig):
        super().__init__()
        self.dtype = compute_dtype(cfg)
        self.dense = nn.Linear(2 * cfg.hidden_size, cfg.hidden_size)
        self.out_proj = nn.Linear(cfg.hidden_size, 2)

    def forward(self, features):
        x = torch.tanh(self.dense(features.to(self.dtype)))
        return self.out_proj(x).float()
