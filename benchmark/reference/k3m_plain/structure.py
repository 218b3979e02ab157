"""Structure Aggregation Module and the Link Prediction Modeling (LPM) loss.

Port of k3m_tpu/model/structure.py (reference structure_aggregator,
vilbert_k3m/vilbert_k3m.py:2413-2505, and its finetune variant without the
loss, :3105-3161). Property/value vectors are the mean of each span's two
boundary positions; triples t = W1([c; p; v]) get scores W2(leaky_relu(t)),
a softmax over the valid pairs weights them, and c_final = c + W3(sum
attn * t).

LPM (`with_lpm`): TransE norms ||c + p - v|| of each valid pair against
`num_negative_pv // 2` corrupted entities (other items of the batch) and
the rest corrupted values (other valid pairs of the same item), in
MarginRankingLoss(margin) with target 1, which the reference writes as
relu(margin - pos + neg); `fix_reference_bugs` flips it to textbook
relu(margin + pos - neg). Negatives are drawn without replacement as k
argmins over uniform noise (structure.py:58-77), or injected
(`neg_entity_idx` / `neg_value_idx`).

Under data parallelism (k3m_tpu_torch/dist.py) the batch is the global one: the
zero-pair carry runs over the gathered rows, so a rank's leading zero-pair
item takes the last aggregate of the rank before it (with its gradient);
entity negatives are drawn over the global batch and read the gathered
c_final; the LPM count is global. Injected entity indices are global rows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import K3MConfig
from . import rand as k3m_random
from .layers import Linear
from . import dist


def gather_pair_mean(seq: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """seq [B, L, H], idx [B, P, 2] -> [B, P, H]: the mean of the two
    positions (the one position when begin == end)."""
    b = torch.arange(seq.shape[0], device=seq.device)[:, None]
    return seq[b, idx[..., 0]] * 0.5 + seq[b, idx[..., 1]] * 0.5


def sample_without_replacement(generator, noise_shape, valid_mask, k_take: int):
    """k_take candidates per row, uniform over the valid set, without
    replacement: k argmins of uniform noise (drawn for the global batch,
    `rows_rand`), invalid entries never first.
    Returns (indices [..., k_take], slot_ok [..., k_take])."""
    noise = k3m_random.rows_rand(generator, noise_shape, valid_mask.device)
    noise = torch.where(valid_mask, noise, torch.full_like(noise, 2.0))
    iota = torch.arange(noise_shape[-1], device=noise.device)
    takes = []
    for _ in range(k_take):
        idx = noise.argmin(dim=-1)
        takes.append(idx)
        noise = torch.where(iota == idx[..., None], torch.full_like(noise, 3.0), noise)
    take = torch.stack(takes, dim=-1)
    n_valid = valid_mask.sum(dim=-1, keepdim=True)
    slot_ok = torch.arange(k_take, device=noise.device) < torch.clamp(n_valid, max=k_take)
    return take, slot_ok


def _generator(deterministic: bool, device, fixed_seed: int):
    """The step's LPM generator in training; a fixed seed otherwise, as the
    JAX package uses PRNGKey(0) / PRNGKey(1) there."""
    if not deterministic:
        return k3m_random.active().lpm
    return torch.Generator(device=device).manual_seed(fixed_seed)


class StructureAggregator(nn.Module):
    def __init__(self, cfg: K3MConfig, with_lpm: bool = False):
        super().__init__()
        H = cfg.hidden_size
        self.cfg = cfg
        self.with_lpm = with_lpm
        self.fix_reference_bugs = cfg.fix_reference_bugs
        self.struc_w1 = Linear(3 * H, H)
        self.struc_w2 = Linear(H, 1)
        self.struc_w3 = Linear(H, H)

    def forward(self, c_initial, sequence_output_pv, index_p, index_v, *,
                deterministic: bool = True,
                neg_entity_idx: Optional[torch.Tensor] = None,
                neg_value_idx: Optional[torch.Tensor] = None):
        """Returns (c_final, LPM loss or None)."""
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
            agg_sel = self._carry(agg, n_valid, c_initial)
        c_final = c_initial + self.struc_w3(agg_sel)
        if not self.with_lpm:
            return c_final, None
        return c_final, self._lpm_loss(c_final, p_vecs, v_vecs, valid, deterministic,
                                       neg_entity_idx, neg_value_idx)

    @staticmethod
    def _carry(agg, n_valid, c_initial):
        """The aggregate each item uses: its own, or that of the nearest
        preceding item of the (global) batch that had pairs, or for a
        leading run of zero-pair items c_initial of the batch's first item.
        Found with a cumulative max of the source index over the global
        rows; this rank keeps its own."""
        world = dist.current()
        B = agg.shape[0]
        row0, total = dist.window(B)
        c_first = world.gather_rows(c_initial[0:1])[0:1]       # global row 0's
        agg, n_valid = world.gather_rows(agg), world.all_gather_rows(n_valid)
        idx = torch.arange(total, device=agg.device)
        marked = torch.where(n_valid > 0, idx, torch.full_like(idx, -1))
        src = torch.cummax(marked, dim=0).values[row0:row0 + B]
        agg_with_exc = torch.cat([c_first, agg], dim=0)
        return agg_with_exc[src + 1]

    def _lpm_loss(self, c_final, p_vecs, v_vecs, valid, deterministic,
                  neg_entity_idx, neg_value_idx):
        cfg = self.cfg
        world = dist.current()
        B, P = valid.shape
        dev = valid.device
        row0, total = dist.window(B)
        n_ent = cfg.num_negative_pv // 2
        n_val = cfg.num_negative_pv - n_ent
        cf, pf, vf = c_final.float(), p_vecs.float(), v_vecs.float()
        pos = torch.linalg.vector_norm(cf[:, None, :] + pf - vf, dim=-1)   # [B, P]
        ar_b = torch.arange(B, device=dev)

        # entity negatives: for each (i, j), n_ent items k != i of the
        # global batch
        rows = ar_b + row0
        if neg_entity_idx is None:
            gen = _generator(deterministic, dev, 0)
            cand_ok = (torch.arange(total, device=dev)[None, None, :]
                       != rows[:, None, None]).expand(B, P, total)
            ent_idx, ent_ok = sample_without_replacement(gen, (B, P, total), cand_ok, n_ent)
            gen_v = gen
        else:
            ent_idx = neg_entity_idx.long()
            ent_ok = ent_idx != rows[:, None, None]
            gen_v = None
        ent_ok = ent_ok & valid[:, :, None] & (total > 1)
        cf_all = world.gather_rows(cf)
        neg_ent = torch.linalg.vector_norm(
            cf_all[ent_idx] + pf[:, :, None, :] - vf[:, :, None, :], dim=-1)  # [B, P, n_ent]

        # value negatives: for each (i, j), n_val valid pairs k != j
        if neg_value_idx is None:
            if gen_v is None:
                gen_v = _generator(deterministic, dev, 1)
            eye = torch.eye(P, dtype=torch.bool, device=dev)
            pair_ok = (valid[:, None, :] & ~eye[None]).expand(B, P, P)
            val_idx, val_ok = sample_without_replacement(gen_v, (B, P, P), pair_ok,
                                                         max(n_val, 1))
            val_idx, val_ok = val_idx[..., :n_val], val_ok[..., :n_val]
        else:
            val_idx = neg_value_idx.long()
            val_ok = val_idx != torch.arange(P, device=dev)[None, :, None]
            val_ok = val_ok & valid[ar_b[:, None, None], val_idx]
        val_ok = val_ok & valid[:, :, None]
        neg_val = torch.linalg.vector_norm(
            cf[:, None, None, :] + pf[:, :, None, :] - vf[ar_b[:, None, None], val_idx],
            dim=-1)                                                        # [B, P, n_val]

        margin = cfg.margin
        if cfg.fix_reference_bugs:
            rank = lambda p, n: torch.relu(margin + p - n)
        else:
            rank = lambda p, n: torch.relu(margin - p + n)
        zero = torch.zeros((), device=dev)
        loss_sum = (torch.where(ent_ok, rank(pos[:, :, None], neg_ent), zero).sum()
                    + torch.where(val_ok, rank(pos[:, :, None], neg_val), zero).sum())
        count = world.sum_counts(ent_ok.sum() + val_ok.sum())
        return loss_sum / torch.clamp(count, min=1)
