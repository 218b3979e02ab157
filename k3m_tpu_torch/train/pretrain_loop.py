"""Pretraining driver on one device: the train step and the epoch loop.

Port of k3m_tpu/train/pretrain_loop.py (reference train_concap_struc.py:
466-705, pretrain.py:390-711). One step: stage the batch on the device,
apply the objective's label zeroing, run K3MForPretraining with dropout and
Gumbel/LPM draws from the step's generators, backpropagate the summed loss,
and update with AdamW once every `grad_accum_steps` steps (the k gradients
averaged, as optax.MultiSteps does).

Loss composition (ref :481-533):
  objective == 1: zero lm/image labels of rows whose is_next labels are not 0
  objective == 2: the alignment loss is reported as 0
  loss = masked_lm_loss + masked_img_loss * loss_img_weight
         + masked_lm_loss_pv + loss_struc      (alignment CE is logged only)

Per-step randomness comes from `StepRandom(seed, step)`, the counterpart of
`fold_in(base_rng, step)` (:202-209), so a resumed run redraws the same
noise. Randomness injected through the batch (`INJECT_KEYS`) replaces the
model's own draws, as in the JAX trainer.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Dict, Iterable, Optional, Set

import numpy as np
import torch

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.model.pretrain import build_pretraining_model
from k3m_tpu_torch.model.random import StepRandom
from k3m_tpu_torch.train.optim import make_optimizer
from k3m_tpu_torch.train.state import CheckpointManager

logger = logging.getLogger(__name__)

LOSS_KEYS = ("masked_lm_loss", "masked_img_loss", "masked_lm_loss_pv",
             "next_sentence_loss_t_v_pv", "loss_struc", "loss")

BATCH_KEYS = ("input_ids", "input_mask", "segment_ids", "lm_label_ids",
              "is_next", "input_ids_pv", "input_mask_pv", "segment_ids_pv",
              "lm_label_ids_pv", "is_next_pv_v", "is_next_pv_t",
              "index_p", "index_v", "image_feat", "image_loc", "image_target",
              "image_label", "image_mask")

INJECT_KEYS = ("neg_entity_idx", "neg_value_idx", "gumbel_noise",
               "neg_image_idx")


def apply_objective(batch: Dict[str, torch.Tensor], objective: int):
    """objective == 1 label zeroing (ref train_concap_struc.py:481-493)."""
    if objective != 1:
        return batch
    replace = batch["is_next"] + batch["is_next_pv_v"] + batch["is_next_pv_t"]
    keep = (replace == 0).long()[:, None]

    def zero_to_ignore(labels):
        z = labels * keep
        return torch.where(z == 0, torch.full_like(z, -1), z)

    out = dict(batch)
    for key in ("image_label", "lm_label_ids", "lm_label_ids_pv"):
        out[key] = zero_to_ignore(batch[key])
    return out


def total_loss(out: Dict[str, torch.Tensor], loss_img_weight: float,
               objective: int):
    """(loss to backpropagate, metrics) from the model's loss dict."""
    align = out["next_sentence_loss_t_v_pv"]
    if objective == 2:
        align = align * 0.0
    img = out["masked_img_loss"] * loss_img_weight
    loss = out["masked_lm_loss"] + img + out["masked_lm_loss_pv"] + out["loss_struc"]
    metrics = dict(loss=loss, masked_lm_loss=out["masked_lm_loss"],
                   masked_img_loss=img, masked_lm_loss_pv=out["masked_lm_loss_pv"],
                   next_sentence_loss_t_v_pv=align, loss_struc=out["loss_struc"])
    return loss, {k: v.detach() for k, v in metrics.items()}


class PretrainTrainer:
    def __init__(self, config: K3MConfig, *, learning_rate: float = 1e-4,
                 warmup_steps: int = 0, total_steps: int = 1000,
                 weight_decay: float = 0.01, grad_accum_steps: int = 1,
                 adam_eps: float = 1e-8, loss_img_weight: float = 1.0,
                 objective: int = 0, seed: int = 42, device="cuda",
                 wire: str = "fp", skip_nonfinite: bool = False,
                 pretrained: Optional[Set[str]] = None, model=None):
        if wire not in ("fp", "exact"):
            raise NotImplementedError(f"wire {wire!r} is not ported yet (fp, exact)")
        self.config = config
        self.model = model if model is not None else build_pretraining_model(
            config, seed=seed, device=device)
        self.device = next(self.model.parameters()).device
        self.seed = seed
        self.wire = wire
        self.loss_img_weight = loss_img_weight
        self.objective = objective
        self.grad_accum_steps = grad_accum_steps
        self.skip_nonfinite = skip_nonfinite
        self.opt, self.sched = make_optimizer(
            self.model, learning_rate, warmup_steps, total_steps,
            weight_decay=weight_decay, adam_eps=adam_eps, pretrained=pretrained)
        self.step = 0        # train_step calls so far (the JAX state.step)
        self._micro = 0      # steps accumulated since the last update

    # ------------------------------------------------------------ staging

    def _to_device(self, key: str, value):
        t = torch.from_numpy(np.ascontiguousarray(value)) \
            if isinstance(value, np.ndarray) else torch.as_tensor(value)
        if self.wire == "fp" and self.config.dtype == "bfloat16":
            # halve the two largest host->device tensors: image_feat goes
            # to the compute dtype (its first use casts it anyway), the
            # soft labels in [0, 1] to fp16 (:336-353)
            if key == "image_feat":
                t = t.to(torch.bfloat16)
            elif key == "image_target" and self.config.visual_target == 0:
                t = t.to(torch.float16)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        else:
            t = t.to(self.device)
        return t if t.is_floating_point() else t.long()

    def stage(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The model's inputs (and injected draws) of a host batch on the
        device; a staged batch passes through."""
        if isinstance(batch.get("input_ids"), torch.Tensor) \
                and batch["input_ids"].device == self.device:
            return batch
        out = {}
        for key in BATCH_KEYS + INJECT_KEYS:
            if key not in batch:
                continue
            v = batch[key]
            out[key] = ({k: self._to_device(key, x) for k, x in v.items()}
                        if isinstance(v, dict) else self._to_device(key, v))
        return out

    # -------------------------------------------------------------- steps

    def losses(self, batch: Dict[str, torch.Tensor], *, deterministic: bool,
               rng: Optional[StepRandom] = None):
        """(loss, metrics) of a staged batch."""
        batch = apply_objective(dict(batch), self.objective)
        inject = {k: batch.pop(k) for k in INJECT_KEYS if k in batch}
        out = self.model(batch, deterministic=deterministic, rng=rng, **inject)
        return total_loss(out, self.loss_img_weight, self.objective)

    def train_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One step; returns its metrics as device scalars (no sync)."""
        staged = self.stage(batch)
        self.model.train()
        rng = StepRandom(self.seed, self.step, self.device)
        loss, metrics = self.losses(staged, deterministic=False, rng=rng)
        (loss / self.grad_accum_steps).backward()
        self.step += 1
        self._micro += 1
        if self._micro == self.grad_accum_steps:
            self._micro = 0
            if self.skip_nonfinite and not self._grads_finite():
                metrics["nonfinite_skipped"] = torch.ones((), device=self.device)
            else:
                # optax decays a parameter whose gradient is zero; torch's
                # AdamW skips one without a gradient, so the parameters the
                # loss does not reach (the NSP head under objective 2, frozen
                # layers) get a zero gradient
                for p in self.model.parameters():
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                self.opt.step()
                self.sched.step()
            self.opt.zero_grad(set_to_none=True)
        return metrics

    def _grads_finite(self) -> bool:
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        return bool(torch.stack([g.isfinite().all() for g in grads]).all())

    @torch.no_grad()
    def eval_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        self.model.eval()
        return self.losses(self.stage(batch), deterministic=True)[1]

    # ---------------------------------------------------------- checkpoint

    def state_dict(self) -> dict:
        return dict(model=self.model.state_dict(), optimizer=self.opt.state_dict(),
                    scheduler=self.sched.state_dict(), step=self.step,
                    micro=self._micro)

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["optimizer"])
        self.sched.load_state_dict(state["scheduler"])
        self.step, self._micro = int(state["step"]), int(state["micro"])

    # ---------------------------------------------------------------- fit

    def fit(self, train_loader: Iterable, val_loader: Optional[Iterable] = None,
            num_epochs: int = 1, start_epoch: int = 0, log_steps: int = 20,
            checkpoint_dir: Optional[str] = None):
        """Train epochs [start_epoch, num_epochs), checkpointing after each
        into `checkpoint_dir` (`checkpoint_seconds`: the write's host time).
        Each step ends with a device synchronisation so that its host time
        (`step_seconds`) is the step's; every step's losses are kept
        (`step_losses`)."""
        ckpt = CheckpointManager(checkpoint_dir, self.config) if checkpoint_dir else None
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        history = []
        for epoch in range(start_epoch, num_epochs):
            for ld in (train_loader, val_loader):
                if hasattr(ld, "epoch"):
                    # the true epoch keys the shuffle and the masking draws,
                    # so a resumed run sees the uninterrupted run's data
                    ld.epoch = epoch
            t_epoch = time.perf_counter()
            seconds, samples, step_metrics = [], [], []
            t_prev = time.perf_counter()
            for batch in train_loader:
                metrics = self.train_step(batch)
                sync()
                t_now = time.perf_counter()
                seconds.append(t_now - t_prev)
                t_prev = t_now
                samples.append(int(np.shape(batch["input_ids"])[0]))
                step_metrics.append(metrics)
                if log_steps and len(seconds) % log_steps == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    logger.info("epoch %d step %d loss %.3f t %.3f v %.3f pv %.3f "
                                "tri %.3f align %.3f (%.3f s)", epoch, len(seconds),
                                m["loss"], m["masked_lm_loss"], m["masked_img_loss"],
                                m["masked_lm_loss_pv"], m["loss_struc"],
                                m["next_sentence_loss_t_v_pv"], seconds[-1])
            dt = time.perf_counter() - t_epoch
            summary = dict(epoch=epoch, seconds=dt, samples_per_sec=sum(samples) / max(dt, 1e-9),
                           step_seconds=seconds, step_samples=samples,
                           step_losses=[{k: float(v) for k, v in m.items()}
                                        for m in step_metrics])
            if val_loader is not None:
                vals = [{k: float(v) for k, v in self.eval_step(b).items()}
                        for b in val_loader]
                for k in LOSS_KEYS:
                    summary[f"val_{k}"] = (float(np.mean([v[k] for v in vals]))
                                           if vals else math.nan)
            if ckpt is not None:
                t_save = time.perf_counter()
                summary["checkpoint_path"] = ckpt.save(self.state_dict(), epoch)
                summary["checkpoint_seconds"] = time.perf_counter() - t_save
            history.append(summary)
        return history
