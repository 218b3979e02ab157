"""Item-alignment evaluation and prediction on one device.

Port of the inference half of k3m_tpu/train/alignment_loop.py (reference
finetune.py: eval threshold sweep :1092-1096, predict jsonl dump
:1116-1212). Batches come from `k3m_tpu_torch.data.pipeline.AlignmentLoader`
as numpy arrays, are copied to the model's device and run under
`torch.inference_mode()`. The train loop comes with a later slice.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Iterable

import numpy as np
import torch

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


def item_to_device(item: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The model inputs of one item on `device`: integer arrays as int64
    (embedding and gather indices), float arrays as they are (the model
    casts the image features to its compute dtype on the device)."""
    out = {}
    for k in ITEM_KEYS:
        if k in item:
            t = torch.from_numpy(np.ascontiguousarray(item[k]))
            if not t.is_floating_point():
                t = t.long()
            out[k] = t.to(device)
    return out


def batch_to_device(batch: Dict, device) -> Dict:
    return dict(label=torch.from_numpy(np.asarray(batch["label"], np.float32)).to(device),
                item1=item_to_device(batch["item1"], device),
                item2=item_to_device(batch["item2"], device))


def forward(model, device_batch: Dict):
    """(emb1, emb2, probs, loss) of one batch already on the model's device."""
    with torch.inference_mode():
        return model(device_batch["label"], device_batch["item1"],
                     device_batch["item2"], deterministic=True)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def evaluate(model, loader: Iterable, epoch: int = 0):
    """Threshold sweep 0.1..0.9 P/R/F1 (ref :1092-1096)."""
    device = _device_of(model)
    all_probs, all_labels = [], []
    for batch in loader:
        _, _, probs, _ = forward(model, batch_to_device(batch, device))
        all_probs.append(probs.float().cpu().numpy())
        all_labels.append(np.asarray(batch["label"]))
    probs = np.concatenate(all_probs)
    labels = np.concatenate(all_labels).astype(int)
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
            log_steps: int = 100) -> Dict:
    """Embedding dump in the JAX package's jsonl format (ref :1119-1212).

    Returns the output path and, per batch, its pairs and the host seconds
    from the end of the previous batch to this batch's results on the host
    (loader wait, copies and the forward)."""
    device = _device_of(model)
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    seconds, pairs = [], []
    t_prev = time.perf_counter()
    with open(output_path, "w", encoding="utf-8") as w:
        for step, batch in enumerate(loader):
            e1, e2, _, _ = forward(model, batch_to_device(batch, device))
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
    logger.info("[Prediction] finished -> %s", output_path)
    return dict(output=output_path, batch_seconds=seconds, batch_pairs=pairs)
