"""Structure Aggregation Module (finetune variant, without the LPM loss).

Port of k3m_tpu/model/structure.py:42-132 (reference structure_aggregator,
vilbert_k3m/vilbert_k3m.py:3105-3161). Property/value vectors are the mean
of each span's two boundary positions; triples t = W1([c; p; v]) get
scores W2(leaky_relu(t)), a softmax over the valid pairs weights them, and
c_final = c + W3(sum attn * t). The LPM loss (structure.py:134-195) belongs
to pretraining and is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from k3m_tpu_torch.config import K3MConfig


def gather_pair_mean(seq: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """seq [B, L, H], idx [B, P, 2] -> [B, P, H]: the mean of the two
    positions (the one position when begin == end)."""
    b = torch.arange(seq.shape[0], device=seq.device)[:, None]
    return seq[b, idx[..., 0]] * 0.5 + seq[b, idx[..., 1]] * 0.5


class StructureAggregator(nn.Module):
    def __init__(self, cfg: K3MConfig, with_lpm: bool = False):
        super().__init__()
        if with_lpm:
            raise NotImplementedError("the LPM loss is not ported yet")
        H = cfg.hidden_size
        self.fix_reference_bugs = cfg.fix_reference_bugs
        self.struc_w1 = nn.Linear(3 * H, H)
        self.struc_w2 = nn.Linear(H, 1)
        self.struc_w3 = nn.Linear(H, H)

    def forward(self, c_initial, sequence_output_pv, index_p, index_v):
        """Returns (c_final, None)."""
        B, P, _ = index_p.shape
        H = c_initial.shape[-1]
        valid = index_p[:, :, 0] != 0                          # [B, P]
        n_valid = valid.sum(dim=1)                             # [B]
        p_vecs = gather_pair_mean(sequence_output_pv, index_p)
        v_vecs = gather_pair_mean(sequence_output_pv, index_v)
        c_rep = c_initial[:, None, :].expand(B, P, H)
        t = self.struc_w1(torch.cat([c_rep, p_vecs, v_vecs], dim=-1))
        b = self.struc_w2(F.leaky_relu(t, 0.01))[..., 0].float()
        b = torch.where(valid, b, torch.full_like(b, -1e30))
        atten = torch.softmax(b, dim=1)[..., None]
        agg = (atten.to(t.dtype) * t).sum(dim=1)               # [B, H]

        # Zero-pair items reuse the aggregate of the most recent preceding
        # item that had pairs (the reference never resets `t` between
        # items); a leading run of zero-pair items uses c_initial[0]. Found
        # with a cumulative max of the source index. fix_reference_bugs
        # gives the clean per-item fallback c_final = c + W3(c).
        if self.fix_reference_bugs:
            agg_sel = torch.where((n_valid > 0)[:, None], agg, c_initial)
        else:
            idx = torch.arange(B, device=agg.device)
            marked = torch.where(n_valid > 0, idx, torch.full_like(idx, -1))
            src = torch.cummax(marked, dim=0).values
            agg_with_exc = torch.cat([c_initial[0:1], agg], dim=0)
            agg_sel = agg_with_exc[src + 1]
        return c_initial + self.struc_w3(agg_sel), None
