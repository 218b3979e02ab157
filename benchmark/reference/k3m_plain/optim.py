"""AdamW with the reference's parameter groups and schedule.

Port of k3m_tpu/train/optim.py (reference train_concap_struc.py:352-448,
pretrain.py:372-384):
  * weight decay 0.01, except biases and LayerNorm parameters (:244);
  * weights loaded from a pretrained checkpoint train at 0.1x the LR;
  * AdamW betas (0.9, 0.98), eps 1e-8;
  * WarmupLinearSchedule: linear 0 -> lr over the warmup, then linear
    decay to 0, evaluated at the number of updates done so far, so the
    first update's LR is schedule(0) = 0.

torch.optim.AdamW's update, p <- p (1 - lr wd) - lr m_hat / (sqrt(v_hat) +
eps), is optax's scale_by_adam -> add_decayed_weights -> scale_by_lr in
the JAX package: -lr (m_hat / (sqrt(v_hat) + eps) + wd p).
"""

from __future__ import annotations

from typing import Iterable, Optional, Set, Tuple

import torch


def is_no_decay(name: str) -> bool:
    """Biases and LayerNorm parameters take no weight decay (ref :244)."""
    return "bias" in name or "LayerNorm" in name


def warmup_linear_schedule(warmup_steps: int, total_steps: int):
    """The LR multiplier of update `step` (0-based), as
    k3m_tpu/train/optim.py:39-52 computes it."""
    warmup = max(int(warmup_steps), 1)
    total = max(int(total_steps), warmup + 1)

    def factor(step: int) -> float:
        if step < warmup:
            return step / warmup
        return max((total - step) / max(total - warmup, 1), 0.0)

    return factor


def param_groups(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                 lr: float, weight_decay: float,
                 pretrained: Optional[Set[str]] = None):
    """Groups (decay or not) x (pretrained at 0.1 lr or not), empty ones
    dropped; each group carries its own lr and weight_decay."""
    groups = {}
    for name, p in named_params:
        if not p.requires_grad:
            continue
        key = (not is_no_decay(name), bool(pretrained and name in pretrained))
        groups.setdefault(key, []).append(p)
    return [dict(params=ps, lr=lr * (0.1 if pre else 1.0),
                 weight_decay=weight_decay if decay else 0.0)
            for (decay, pre), ps in sorted(groups.items())]


def make_optimizer(model: torch.nn.Module, learning_rate: float,
                   warmup_steps: int, total_steps: int, *,
                   weight_decay: float = 0.01, adam_eps: float = 1e-8,
                   betas=(0.9, 0.98), pretrained: Optional[Set[str]] = None):
    """(AdamW, LambdaLR): call `scheduler.step()` after each update."""
    opt = torch.optim.AdamW(
        param_groups(model.named_parameters(), learning_rate, weight_decay, pretrained),
        lr=learning_rate, betas=betas, eps=adam_eps)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, warmup_linear_schedule(warmup_steps, total_steps))
    return opt, sched
