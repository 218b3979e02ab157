"""Item-alignment finetune on one device: train loop, threshold-sweep
eval, prediction.

Port of k3m_tpu/train/alignment_loop.py (reference finetune.py: train
:850-984, eval threshold sweep :1092-1096, predict jsonl dump :1116-1212).
Batches come from `k3m_tpu_torch.data.pipeline.AlignmentLoader` as numpy
arrays. `AlignmentTrainer` stages them on the device (ahead of their use,
in `fit`) and trains K3MForItemAlignment with the step's dropout, attention
dropout and Gumbel draws (`StepRandom(seed, step)`, as pretraining draws
them), in-step microbatches, gradient accumulation and AdamW with every
weight at the full LR (the JAX trainer passes no pretrained set). Under
the `int8` wire each item's image features cross quantized and are decoded
on the device; with the device cache (`device_cache`) the first epoch's
staged batches are replayed after it. `evaluate` and `predict` run a model
under `torch.inference_mode()`.

Over a world of processes (k3m_tpu_torch/dist.py) each rank reads its
shard of the pairs; the global batch is the ranks' batches in rank
order, as in the JAX package. The trainer sums the gradients and the
logged loss over the ranks and rank 0 writes the checkpoints; `evaluate`
gathers every rank's probabilities and labels before the sweep, which
every rank then computes alike (JAX alignment_loop.py:316-323);
`predict` writes one part per rank, `<output>.part<rank>` (:339-340).
Under tensor parallelism (train/mesh.py) "rank" reads the data axis: the
model ranks of a data group read the same pairs, the gathers run over the
data groups, and model rank 0 of each data group writes its part.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from k3m_tpu_torch.config import K3MConfig
from k3m_tpu_torch.model.alignment import build_model
from k3m_tpu_torch.model.layers import compute_dtype
from k3m_tpu_torch.dist import World
from k3m_tpu_torch.train.state import CheckpointManager
from k3m_tpu_torch.train.trainer import (
    Trainer, allreduce_summary, batch_rows, host_array, stage_batch, wire_plan,
)
from k3m_tpu_torch.train.wire import decode, wire_mode
from k3m_tpu_torch.utils import trace

logger = logging.getLogger(__name__)

ITEM_KEYS = ("input_ids", "input_mask", "segment_ids", "input_ids_pv",
             "input_mask_pv", "segment_ids_pv", "index_p", "index_v",
             "image_feat", "image_loc", "image_mask")


def precision_recall_f1(labels: np.ndarray, preds: np.ndarray):
    tp = float(((preds == 1) & (labels == 1)).sum())
    fp = float(((preds == 1) & (labels == 0)).sum())
    fn = float(((preds == 0) & (labels == 1)).sum())
    p = tp / (tp + fp) if tp + fp else 0.0
    r = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    return p, r, f1


def batch_to_device(batch: Dict, device, config=None, wire: str = "exact") -> Dict:
    """A host pair batch's model inputs on `device`, as the trainer, the
    sweep and predict stage them (`stage_batch`): labels fp32, integer
    arrays int64, image_feat in the wire's form (bf16 under the `fp` wire
    and a bf16 `config`, int8 and its row scales under `int8`, which
    `decode_items` undoes on the device). A batch already there passes
    through."""
    device = torch.device(device)
    if isinstance(batch.get("label"), torch.Tensor) and batch["label"].device == device:
        return batch
    return stage_batch(lambda: dict(
        label=host_array("label", np.asarray(batch["label"], np.float32)),
        **{side: wire_plan(batch[side], ITEM_KEYS, config, wire)
           for side in ("item1", "item2")}), device)


def decode_items(batch: Dict, config) -> Dict:
    """A staged pair batch with each item's wire forms decoded on the
    device, item by item (k3m_tpu/train/alignment_loop.py:206-222)."""
    dt = compute_dtype(config)
    return dict(batch, item1=decode(batch["item1"], dt), item2=decode(batch["item2"], dt))


@trace.spanned("k3m.forward")
def forward(model, device_batch: Dict, world: Optional[World] = None):
    """(emb1, emb2, probs, loss) of one batch already on the model's device;
    `world`: the ranks whose batches make the global one."""
    b = decode_items(device_batch, model.cfg)
    with torch.inference_mode():
        return model(b["label"], b["item1"], b["item2"], deterministic=True, world=world)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def evaluate(model, loader: Iterable, epoch: int = 0, wire: Optional[str] = None,
             world: Optional[World] = None):
    """Threshold sweep 0.1..0.9 P/R/F1 (ref :1092-1096); `wire` defaults
    to K3M_WIRE, else fp. Over a world of processes each rank evaluates its
    shard (of equal length on every rank) and the sweep is over every
    rank's pairs."""
    device, wire = _device_of(model), wire_mode(wire)
    world = world or World(device=device)
    model.eval()
    all_probs, all_labels = [], []
    for batch in loader:
        _, _, probs, _ = forward(model, batch_to_device(batch, device, model.cfg, wire), world)
        all_probs.append(probs.float())
        all_labels.append(torch.as_tensor(np.asarray(batch["label"]), dtype=torch.float32))
    probs = world.all_gather_rows(torch.cat(all_probs)).cpu().numpy()
    labels = world.all_gather_rows(torch.cat(all_labels).to(device)).cpu().numpy().astype(int)
    sweep = {}
    for threshold in np.arange(0.1, 1.0, 0.1):
        p, r, f1 = precision_recall_f1(labels, (probs >= threshold).astype(int))
        sweep[round(float(threshold), 1)] = dict(precision=p, recall=r, f1=f1)
        logger.info("[Epoch-%d] threshold=%.1f precision=%.4f recall=%.4f "
                    "f1=%.4f", epoch, threshold, p, r, f1)
    return sweep


def _fmt(e: np.ndarray) -> str:
    return "[" + ",".join(str(x) for x in e) + "]" if e.ndim else str(e)


def predict(model, loader: Iterable, output_path: str, threshold: float = 0.5,
            log_steps: int = 100, wire: Optional[str] = None,
            world: Optional[World] = None) -> Dict:
    """Embedding dump in the JAX package's jsonl format (ref :1119-1212).

    Returns the output path (None on a model rank other than 0) and, per
    batch, its pairs and the host seconds from the end of the previous batch
    to this batch's results on the host (loader wait, copies and the
    forward). `wire` defaults to K3M_WIRE, else fp. Over a world of
    processes each data group writes its shard's pairs to
    `<output_path>.part<data index>`, from its model rank 0; the parts
    together are the dump."""
    device, wire = _device_of(model), wire_mode(wire)
    world = world or World(device=device)
    if world.data_size > 1:
        output_path = f"{output_path}.part{world.data_rank}"
    writer = world.model_rank == 0
    if writer:
        os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    seconds, pairs = [], []
    t_prev = time.perf_counter()
    with open(output_path if writer else os.devnull, "w", encoding="utf-8") as w:
        for step, batch in enumerate(loader):
            e1, e2, _, _ = forward(model, batch_to_device(batch, device, model.cfg, wire),
                                   world)
            e1 = e1.float().cpu().numpy()
            e2 = e2.float().cpu().numpy()
            t_now = time.perf_counter()
            seconds.append(t_now - t_prev)
            pairs.append(len(e1))
            t_prev = t_now
            ids1 = batch["item1"].get("item_id", [""] * len(e1))
            ids2 = batch["item2"].get("item_id", [""] * len(e2))
            for sid, tid, se, te in zip(ids1, ids2, e1, e2):
                w.write(json.dumps({
                    "src_item_id": sid, "src_item_emb": _fmt(se),
                    "tgt_item_id": tid, "tgt_item_emb": _fmt(te),
                    "threshold": threshold}) + "\n")
            if log_steps and step % log_steps == 0:
                logger.info("[Prediction] %d batches processed", step)
    logger.info("[Prediction] finished -> %s", output_path if writer else os.devnull)
    return dict(output=output_path if writer else None, batch_seconds=seconds,
                batch_pairs=pairs)


class AlignmentTrainer(Trainer):
    """The counterpart of the JAX AlignmentTrainer (alignment_loop.py:
    59-356), on one device or one rank of a `world`; `model` defaults to a
    training K3MForItemAlignment with random weights from `seed`."""

    def __init__(self, config: K3MConfig, *, learning_rate: float = 5e-5,
                 warmup_steps: int = 0, total_steps: int = 1000,
                 grad_accum_steps: int = 1, micro_steps: int = 1,
                 adam_eps: float = 1e-8, seed: int = 42, device="cuda",
                 wire: Optional[str] = None, device_cache: Optional[bool] = None,
                 skip_nonfinite: bool = False, model=None,
                 world: Optional[World] = None):
        model = model if model is not None else build_model(
            config, seed=seed, device=device, train=True)
        super().__init__(config, model, learning_rate=learning_rate,
                         warmup_steps=warmup_steps, total_steps=total_steps,
                         grad_accum_steps=grad_accum_steps, micro_steps=micro_steps,
                         adam_eps=adam_eps, seed=seed, wire=wire,
                         device_cache=device_cache, skip_nonfinite=skip_nonfinite,
                         world=world)

    def stage(self, batch: Dict) -> Dict:
        return batch_to_device(batch, self.device, self.config, self.wire)

    def train_step(self, batch: Dict):
        """One step; returns (loss, probs) on the device (no sync)."""
        staged = decode_items(self.stage(batch), self.config)
        self.model.train()
        losses, probs = [], []
        for rows, rng in self.micro_slices(staged["label"].shape[0]):
            with trace.span("k3m.forward"):
                part = batch_rows(staged, rows)
                _, _, p, loss = self.model(part["label"], part["item1"], part["item2"],
                                           deterministic=False, rng=rng, world=self.world)
            with trace.span("k3m.backward"):
                (loss / (self.micro_steps * self.grad_accum_steps)).backward()
            losses.append(loss.detach())
            probs.append(p.detach())
        loss = losses[0] if len(losses) == 1 else torch.stack(losses).mean()
        loss = self.global_metrics(dict(loss=loss))["loss"]
        self.update()
        return loss, torch.cat(probs)

    @trace.spanned("k3m.fit")
    def fit(self, train_loader: Iterable, val_loader: Optional[Iterable] = None,
            num_epochs: int = 1, start_epoch: int = 0, log_steps: int = 20,
            checkpoint_dir: Optional[str] = None):
        """Train epochs [start_epoch, num_epochs); after each, the threshold
        sweep on `val_loader` (`sweep`) and a checkpoint into
        `checkpoint_dir` (`checkpoint_seconds`: the write's host time; rank
        0 writes, the path is None on the other ranks). Each step ends with a
        device synchronisation so that its host time (`step_seconds`) is the
        step's; every step's loss (the global batch's) is kept
        (`step_losses`). Spans (utils/trace.py): `k3m.fit`, `k3m.epoch`,
        `k3m.step`, `k3m.sync`."""
        ckpt = (CheckpointManager(checkpoint_dir, self.config)
                if checkpoint_dir and self.world.rank == 0 else None)
        source = self.epoch_source(train_loader)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        history = []
        for epoch in range(start_epoch, num_epochs):
            if hasattr(source, "epoch"):
                # the true epoch keys the shuffle, so a resumed run sees the
                # uninterrupted run's order
                source.epoch = epoch
            cache = self.epoch_cache if self.device_cache else None
            from_cache = cache is not None and cache.cached
            t_epoch = t_prev = time.perf_counter()
            seconds, pairs, losses, allreduce = [], [], [], []
            with trace.span("k3m.epoch", epoch=epoch):
                for batch in self.prefetch(source):
                    pairs.append(int(batch["label"].shape[0]))
                    with trace.span("k3m.step", samples=pairs[-1]):
                        loss, _ = self.train_step(batch)
                        with trace.span("k3m.sync"):
                            sync()
                    t_now = time.perf_counter()
                    seconds.append(t_now - t_prev)
                    t_prev = t_now
                    losses.append(loss)
                    allreduce.append(self.allreduce)
                    if log_steps and len(seconds) % log_steps == 0:
                        logger.info("epoch %d step %d loss %.4f (%.3f s)", epoch,
                                    len(seconds), float(loss), seconds[-1])
            dt = time.perf_counter() - t_epoch
            summary = dict(epoch=epoch, seconds=dt, samples_per_sec=sum(pairs) / max(dt, 1e-9),
                           step_seconds=seconds, step_pairs=pairs,
                           step_losses=[float(x) for x in losses])
            if self.world.group:
                summary.update(allreduce_summary(allreduce))
            if cache is not None:
                summary["device_cache"] = dict(from_cache=from_cache, cached=cache.cached,
                                               bytes=cache.bytes, budget_bytes=cache.max_bytes)
            if val_loader is not None:
                summary["sweep"] = evaluate(self.model, val_loader, epoch, self.wire,
                                            self.world)
            if checkpoint_dir:
                t_save = time.perf_counter()
                summary["checkpoint_path"] = self.save_checkpoint(
                    lambda state: ckpt.save(state, epoch))
                summary["checkpoint_seconds"] = time.perf_counter() - t_save
            history.append(summary)
        return history
