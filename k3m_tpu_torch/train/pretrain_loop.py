"""Pretraining driver on one device: the train step and the epoch loop.

Port of k3m_tpu/train/pretrain_loop.py (reference train_concap_struc.py:
466-705, pretrain.py:390-711). One step: stage the batch on the device
(ahead of its use, on a producer thread, in `fit`), apply the objective's
label zeroing, run K3MForPretraining with dropout and Gumbel/LPM draws from
the step's generators, backpropagate the summed loss (over `micro_steps`
slices of the batch where asked), and update with AdamW once every
`grad_accum_steps` steps (train/trainer.py).

Loss composition (ref :481-533):
  objective == 1: zero lm/image labels of rows whose is_next labels are not 0
  objective == 2: the alignment loss is reported as 0
  loss = masked_lm_loss + masked_img_loss * loss_img_weight
         + masked_lm_loss_pv + loss_struc      (alignment CE is logged only)
         (+ moe_balance_loss under the DeepSeek-V2 text block)

Per-step randomness comes from `StepRandom(seed, step)`, the counterpart of
`fold_in(base_rng, step)` (:202-209), so a resumed run redraws the same
noise. Randomness injected through the batch (`INJECT_KEYS`) replaces the
model's own draws, as in the JAX trainer.

Run control, as the JAX trainer's `fit` (:402-527): a full-state step
checkpoint every `save_steps` batches, a mid-epoch start (`start_step`),
SIGTERM handled at the next step boundary (checkpoint, then return with
`preempted_at_step`), `metrics.jsonl` every `log_steps` steps, a warning
where an update was skipped for non-finite gradients, and the device
cache (`device_cache`). Over a world of processes
(k3m_tpu_torch/dist.py) the ranks agree at each step boundary whether
any of them saw SIGTERM, so all stop after the same step; rank 0 writes
the checkpoints and `metrics.jsonl`; the logged losses are the global
batch's.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import math
import signal
import threading
import time
from typing import Dict, Iterable, Optional, Set

import numpy as np
import torch

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.model.layers import compute_dtype
from k3m_tpu_torch.model.pretrain import build_pretraining_model
from k3m_tpu_torch.model.random import StepRandom
from k3m_tpu_torch.dist import World
from k3m_tpu_torch.train.state import CheckpointManager
from k3m_tpu_torch.train.trainer import Trainer, allreduce_summary, batch_rows, stage_arrays
from k3m_tpu_torch.train.wire import decode
from k3m_tpu_torch.utils import trace
from k3m_tpu_torch.utils.metrics import MetricsLogger

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
    balance = out.get("moe_balance_loss")     # the DeepSeek-V2 text block's
    if balance is not None:
        loss = loss + balance
    metrics = dict(loss=loss, masked_lm_loss=out["masked_lm_loss"],
                   masked_img_loss=img, masked_lm_loss_pv=out["masked_lm_loss_pv"],
                   next_sentence_loss_t_v_pv=align, loss_struc=out["loss_struc"])
    if balance is not None:
        metrics["moe_balance_loss"] = balance
    return loss, {k: v.detach() for k, v in metrics.items()}


class PretrainTrainer(Trainer):
    def __init__(self, config: K3MConfig, *, learning_rate: float = 1e-4,
                 warmup_steps: int = 0, total_steps: int = 1000,
                 weight_decay: float = 0.01, grad_accum_steps: int = 1,
                 micro_steps: int = 1, adam_eps: float = 1e-8,
                 loss_img_weight: float = 1.0, objective: int = 0, seed: int = 42,
                 device="cuda", wire: Optional[str] = None,
                 device_cache: Optional[bool] = None, skip_nonfinite: bool = False,
                 pretrained: Optional[Set[str]] = None, model=None,
                 world: Optional[World] = None):
        # slices see a smaller pool of in-batch negatives (JAX :124-132)
        if micro_steps > 1 and (config.visual_target == 2 or config.in_batch_pairs):
            raise ValueError(
                "micro_steps > 1 changes the in-batch negative pool of "
                "visual_target=2 / in_batch_pairs; use micro_steps=1")
        model = model if model is not None else build_pretraining_model(
            config, seed=seed, device=device)
        super().__init__(config, model, learning_rate=learning_rate,
                         warmup_steps=warmup_steps, total_steps=total_steps,
                         weight_decay=weight_decay, grad_accum_steps=grad_accum_steps,
                         micro_steps=micro_steps, adam_eps=adam_eps, seed=seed, wire=wire,
                         device_cache=device_cache, skip_nonfinite=skip_nonfinite,
                         pretrained=pretrained, world=world)
        self.loss_img_weight = loss_img_weight
        self.objective = objective

    def stage(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The model's inputs (and injected draws) of a host batch on the
        device, in the wire's form; a staged batch passes through."""
        if isinstance(batch.get("input_ids"), torch.Tensor) \
                and batch["input_ids"].device == self.device:
            return batch
        return stage_arrays(batch, BATCH_KEYS + INJECT_KEYS, self.device, self.config,
                            self.wire)

    # -------------------------------------------------------------- steps

    @trace.spanned("k3m.forward")
    def losses(self, batch: Dict[str, torch.Tensor], *, deterministic: bool,
               rng: Optional[StepRandom] = None):
        """(loss, metrics) of a staged batch (span `k3m.forward`)."""
        batch = decode(dict(batch), compute_dtype(self.config))
        batch = apply_objective(batch, self.objective)
        inject = {k: batch.pop(k) for k in INJECT_KEYS if k in batch}
        out = self.model(batch, deterministic=deterministic, rng=rng, world=self.world,
                         **inject)
        return total_loss(out, self.loss_img_weight, self.objective)

    def train_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One step; returns its metrics as device scalars (no sync)."""
        staged = self.stage(batch)
        if self.micro_steps > 1 and any(k in staged for k in INJECT_KEYS):
            # injected draws index rows of the whole batch (JAX :232-235)
            raise ValueError("RNG-replay injection requires micro_steps=1")
        self.model.train()
        parts = []
        for rows, rng in self.micro_slices(staged["input_ids"].shape[0]):
            loss, metrics = self.losses(batch_rows(staged, rows), deterministic=False,
                                        rng=rng)
            with trace.span("k3m.backward"):
                (loss / (self.micro_steps * self.grad_accum_steps)).backward()
            parts.append(metrics)
        metrics = parts[0] if len(parts) == 1 else {
            k: torch.stack([m[k] for m in parts]).mean() for k in parts[0]}
        metrics = self.global_metrics(metrics)
        skipped = self.update()
        if self.skip_nonfinite:     # 1.0 where the update was skipped, as in JAX
            metrics["nonfinite_skipped"] = (skipped if skipped is not None
                                            else torch.zeros((), device=self.device))
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        self.model.eval()
        return self.global_metrics(self.losses(self.stage(batch), deterministic=True)[1])

    # ---------------------------------------------------------------- fit

    @trace.spanned("k3m.fit")
    def fit(self, train_loader: Iterable, val_loader: Optional[Iterable] = None,
            num_epochs: int = 1, start_epoch: int = 0, log_steps: int = 20,
            checkpoint_dir: Optional[str] = None, save_steps: Optional[int] = None,
            start_step: int = 0, handle_preemption: bool = True):
        """Train epochs [start_epoch, num_epochs), the first from its batch
        `start_step` (the batches before it are drawn and skipped), with a
        checkpoint after each epoch into `checkpoint_dir`
        (`checkpoint_seconds`: the write's host time), a step checkpoint
        every `save_steps` batches, and `metrics.jsonl` there every
        `log_steps` steps. With `handle_preemption`, on the main thread,
        SIGTERM ends the run after the step in flight with a step checkpoint;
        the history's last entry is then {epoch, preempted_at_step} (and the
        checkpoint's path and seconds). Over a world of processes, SIGTERM
        on any rank stops every rank after the same step; rank 0 writes
        (the path is None on the others). Each
        step ends with a device synchronisation so that its host time
        (`step_seconds`) is the step's; every step's losses are kept
        (`step_losses`). Spans (utils/trace.py): `k3m.fit`, `k3m.epoch`,
        `k3m.step`, `k3m.sync`."""
        writer = checkpoint_dir and self.world.rank == 0
        ckpt = CheckpointManager(checkpoint_dir, self.config) if writer else None
        mlog = MetricsLogger(checkpoint_dir) if writer else None
        source = self.epoch_source(train_loader)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        preempted = threading.Event()
        old_handler = None
        if handle_preemption and threading.current_thread() is threading.main_thread():
            def on_sigterm(signum, frame):
                logger.info("SIGTERM: checkpointing after the step in flight, then returning")
                preempted.set()
            old_handler = signal.signal(signal.SIGTERM, on_sigterm)
        history = []
        try:
            for epoch in range(start_epoch, num_epochs):
                for ld in (source, val_loader):
                    if hasattr(ld, "epoch"):
                        # the true epoch keys the shuffle and the masking
                        # draws, so a resumed run sees the uninterrupted
                        # run's data
                        ld.epoch = epoch
                with trace.span("k3m.epoch", epoch=epoch):
                    summary = self._epoch(source, epoch,
                                          start_step if epoch == start_epoch else 0, ckpt,
                                          bool(checkpoint_dir), mlog, save_steps, log_steps,
                                          preempted, sync)
                history.append(summary)
                if "preempted_at_step" in summary:
                    return history
                if val_loader is not None:
                    vals = [{k: float(v) for k, v in self.eval_step(b).items()}
                            for b in val_loader]
                    for k in LOSS_KEYS:
                        summary[f"val_{k}"] = (float(np.mean([v[k] for v in vals]))
                                               if vals else math.nan)
                if checkpoint_dir:
                    t_save = time.perf_counter()
                    summary["checkpoint_path"] = self.save_checkpoint(
                        lambda state: ckpt.save(state, epoch))
                    summary["checkpoint_seconds"] = time.perf_counter() - t_save
            return history
        finally:
            if old_handler is not None:
                signal.signal(signal.SIGTERM, old_handler)
            if mlog is not None:
                mlog.close()

    def _epoch(self, source, epoch, skip, ckpt, checkpointing, mlog, save_steps, log_steps,
               preempted, sync) -> dict:
        """One epoch's steps from batch `skip` on; its summary. `ckpt`: the
        CheckpointManager on rank 0, else None; `checkpointing` says
        whether the run checkpoints at all."""
        cache = self.epoch_cache if self.device_cache else None
        from_cache = cache is not None and cache.cached
        batches = itertools.islice(source, skip, None) if skip else source
        t_epoch = t_prev = time.perf_counter()
        seconds, samples, step_metrics, allreduce = [], [], [], []
        with contextlib.closing(self.prefetch(batches)) as staged:
            for step, batch in enumerate(staged, start=skip):
                samples.append(int(batch["input_ids"].shape[0]))
                with trace.span("k3m.step", samples=samples[-1]):
                    metrics = self.train_step(batch)
                    with trace.span("k3m.sync"):
                        sync()
                t_now = time.perf_counter()
                seconds.append(t_now - t_prev)
                t_prev = t_now
                step_metrics.append(metrics)
                allreduce.append(self.allreduce)
                if save_steps and checkpointing and (step + 1) % save_steps == 0:
                    self.save_checkpoint(lambda state: ckpt.save_step(state, epoch, step + 1))
                if self.world.any_flag(preempted.is_set()):
                    out = dict(epoch=epoch, preempted_at_step=step + 1)
                    if checkpointing:
                        t_save = time.perf_counter()
                        out["checkpoint_path"] = self.save_checkpoint(
                            lambda state: ckpt.save_step(state, epoch, step + 1))
                        out["checkpoint_seconds"] = time.perf_counter() - t_save
                        logger.info("preemption checkpoint: epoch %d after %d batches",
                                    epoch, step + 1)
                    return out
                if log_steps and (step + 1) % log_steps == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    if m.get("nonfinite_skipped"):
                        logger.warning("epoch %d step %d: non-finite gradients, update "
                                       "skipped", epoch, step + 1)
                    logger.info("epoch %d step %d loss %.3f t %.3f v %.3f pv %.3f "
                                "tri %.3f align %.3f (%.3f s)", epoch, step + 1,
                                m["loss"], m["masked_lm_loss"], m["masked_img_loss"],
                                m["masked_lm_loss_pv"], m["loss_struc"],
                                m["next_sentence_loss_t_v_pv"], seconds[-1])
                    if mlog is not None:
                        mlog.log(self.step, m)
        dt = time.perf_counter() - t_epoch
        summary = dict(epoch=epoch, seconds=dt, samples_per_sec=sum(samples) / max(dt, 1e-9),
                       step_seconds=seconds, step_samples=samples,
                       step_losses=[{k: float(v) for k, v in m.items()}
                                    for m in step_metrics])
        if self.world.group:
            summary.update(allreduce_summary(allreduce))
        if cache is not None:
            summary["device_cache"] = dict(from_cache=from_cache, cached=cache.cached,
                                           bytes=cache.bytes, budget_bytes=cache.max_bytes)
        return summary
