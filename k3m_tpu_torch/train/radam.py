"""Rectified Adam (RAdam) as a `torch.optim.Optimizer`.

Port of k3m_tpu/train/radam.py (reference vilbert_k3m/optimization.py
RAdam:16 / PlainRAdam:103, which no reference training script constructs;
no CLI of the port builds it either). Per parameter, at step t = 1, 2, ...:

  m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
  N_sma_max = 2 / (1 - b2) - 1;  N_sma = N_sma_max - 2 t b2^t / (1 - b2^t)
  N_sma >= 5:  p -= lr sqrt((1 - b2^t) (N_sma - 4) / (N_sma_max - 4)
                            (N_sma - 2) / N_sma N_sma_max / (N_sma_max - 2))
                   / (1 - b1^t) m / (sqrt(v) + eps)
  N_sma < 5:   p -= lr / (1 - b1^t) m          (un-adapted momentum)

with decoupled weight decay p -= weight_decay lr p from the parameter before
the step, at the raw learning rate (not the rectified step size). `lr` is
the group's at the time of the step, so a torch LR scheduler takes the
place of the JAX package's schedule of the step count.
"""

from __future__ import annotations

import math

import torch


class RAdam(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        if lr < 0.0 or eps < 0.0 or weight_decay < 0.0:
            raise ValueError(f"invalid lr {lr}, eps {eps} or weight_decay {weight_decay}")
        if not all(0.0 <= b < 1.0 for b in betas):
            raise ValueError(f"invalid betas {betas}")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @staticmethod
    def step_sizes(t: int, lr: float, b1: float, b2: float):
        """(step size, adapted): the factor of m (over sqrt(v) + eps where
        adapted) at step t."""
        beta2_t = b2 ** t
        n_sma_max = 2.0 / (1.0 - b2) - 1.0
        n_sma = n_sma_max - 2.0 * t * beta2_t / (1.0 - beta2_t)
        bias1 = 1.0 - b1 ** t
        if n_sma < 5.0:
            return lr / bias1, False
        rect = math.sqrt((1.0 - beta2_t) * (n_sma - 4.0) / (n_sma_max - 4.0)
                         * (n_sma - 2.0) / n_sma * n_sma_max / (n_sma_max - 2.0))
        return lr * rect / bias1, True

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if g.is_sparse:
                    raise RuntimeError("RAdam does not support sparse gradients")
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                m, v = state["exp_avg"], state["exp_avg_sq"]
                state["step"] += 1
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                size, adapted = self.step_sizes(state["step"], lr, b1, b2)
                update = m / (v.sqrt() + eps) if adapted else m.clone()
                update.mul_(size)
                if wd != 0.0:
                    update.add_(p, alpha=wd * lr)
                p.sub_(update)
        return loss
