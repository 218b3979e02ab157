"""Box utilities of the RoI extractor: anchors, delta transforms, IoU and
greedy NMS with static output shapes.

Counterpart of k3m_tpu/vision/boxes.py, which replaces detectron2's box ops
(reference data_prepare.py:199-232). NMS keeps the JAX package's contract:
`max_out` slots of indices plus a validity mask, argmax taking the first
maximum, a `-inf` score never a valid pick. Every function takes leading
dimensions (the images of a batch), so that one Python loop of `max_out`
steps serves a whole batch: each step is a handful of small launches, so
the loop costs about 7 launches a step whatever the batch (no kernel of the
port; a fused NMS is later work, ROADMAP).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

SCALE_CLAMP = math.log(1000.0 / 16)


def generate_anchors(feat_h: int, feat_w: int, stride: int = 16,
                     sizes=(32, 64, 128, 256, 512),
                     aspect_ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """Detectron2 DefaultAnchorGenerator grid anchors, XYXY, [H*W*A, 4] in
    (h, w, a) order."""
    cell = []
    for size in sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = np.sqrt(area / ar)
            h = ar * w
            cell.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    cell = np.asarray(cell, np.float32)                   # [A, 4]
    shift_x = (np.arange(feat_w) * stride).astype(np.float32)
    shift_y = (np.arange(feat_h) * stride).astype(np.float32)
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    anchors = shifts[:, None, :] + cell[None, :, :]
    return anchors.reshape(-1, 4)


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 scale_clamp: float = SCALE_CLAMP) -> torch.Tensor:
    """Box2BoxTransform.apply_deltas: [..., 4] deltas onto [..., 4] XYXY
    boxes (broadcast)."""
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=scale_clamp)
    dh = (deltas[..., 3] / wh).clamp(max=scale_clamp)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h],
                       dim=-1)


def clip_boxes(boxes: torch.Tensor, h, w) -> torch.Tensor:
    """Clip XYXY boxes to [0, w] x [0, h]; `h` and `w` are numbers or
    tensors that broadcast against boxes[..., 0] (one size per image)."""
    h = torch.as_tensor(h, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(w, dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(boxes[..., 0].clamp(min=0), w)
    y1 = torch.minimum(boxes[..., 1].clamp(min=0), h)
    x2 = torch.minimum(boxes[..., 2].clamp(min=0), w)
    y2 = torch.minimum(boxes[..., 3].clamp(min=0), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def box_iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU (no +1; detectron2 convention), a [..., N, 4],
    b [..., M, 4] -> [..., N, M]."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    a, b = a[..., :, None, :], b[..., None, :, :]
    iw = (torch.minimum(a[..., 2], b[..., 2])
          - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    ih = (torch.minimum(a[..., 3], b[..., 3])
          - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    inter = iw * ih
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _greedy(iou: torch.Tensor, scores: torch.Tensor, thresholds: torch.Tensor,
            max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """iou [G, n, n], scores [G, S, n], thresholds [S]: S independent greedy
    passes per group, each against its own threshold, sharing the group's
    IoU matrix. -> (indices [G, S, max_out] int64, valid [G, S, max_out]).

    Per step, as nms_fixed in the JAX package: the alive box of the largest
    score (the first such) is picked; the pick is valid iff that masked
    score is above -inf (the box is alive and not -inf-scored); it and every
    box over the threshold against it die."""
    G, S, n = scores.shape
    alive = torch.ones(G, S, n, dtype=torch.bool, device=scores.device)
    neg = torch.tensor(-math.inf, dtype=scores.dtype, device=scores.device)
    thr = thresholds.to(iou.dtype).view(1, S, 1)
    picks, oks = [], []
    for _ in range(max_out):
        best_score, best = torch.where(alive, scores, neg).max(dim=-1)
        picks.append(best)
        oks.append(best_score > -math.inf)
        row = torch.gather(iou, 1, best.unsqueeze(-1).expand(G, S, n))
        alive.masked_fill_(row > thr, False)
        alive.scatter_(-1, best.unsqueeze(-1), False)
    return torch.stack(picks, dim=-1), torch.stack(oks, dim=-1)


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: Union[float, Sequence[float]],
              max_out: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with static shapes: boxes [..., n, 4], scores [..., n] ->
    (indices [..., max_out], valid [..., max_out]); suppressed or exhausted
    slots are invalid. A sequence of thresholds runs one pass per threshold
    over the same IoU matrix: the outputs then have a dimension of the
    thresholds before the slots."""
    lead, n = scores.shape[:-1], scores.shape[-1]
    many = not isinstance(iou_threshold, (int, float))
    thresholds = torch.as_tensor(iou_threshold if many else [iou_threshold],
                                 dtype=scores.dtype, device=scores.device)
    iou = box_iou_xyxy(boxes, boxes).reshape(-1, n, n)
    S = thresholds.numel()
    idx, valid = _greedy(iou, scores.reshape(-1, 1, n).expand(-1, S, n),
                         thresholds, max_out)
    shape = (*lead, S, max_out) if many else (*lead, max_out)
    return idx.reshape(shape), valid.reshape(shape)


def batched_nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
                      class_ids: torch.Tensor, iou_threshold, max_out: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class NMS via the coordinate-offset trick (torchvision
    batched_nms), the offset taken per leading index (per image)."""
    max_coord = boxes.amax(dim=(-2, -1), keepdim=True) + 1.0
    offsets = class_ids.to(boxes.dtype)[..., None] * max_coord
    return nms_fixed(boxes + offsets, scores, iou_threshold, max_out)
