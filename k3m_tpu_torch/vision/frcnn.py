"""Faster R-CNN R101-C4 RoI extraction: preprocess -> backbone -> RPN ->
proposal NMS -> RoIPool -> res5 -> box predictor -> adaptive class NMS
forcing NUM_OBJECTS boxes.

Counterpart of k3m_tpu/vision/frcnn.py, at its configuration: the
bottom-up-attention detector of the reference's extraction
(data_prepare.py:183-277, 2_generate_tsv_ali.py:82-175):
  * shortest edge 600, longest at most 1000; 15 anchors on stride 16;
  * 6000 proposals before the RPN NMS (0.7), 300 after it;
  * RoIPool 14x14 on the stride-16 map, res5, mean-pooled 2048-d features;
  * 1600 VG classes plus background, class score threshold 0.2;
  * the adaptive NMS sweep 0.5 -> 0.9 by 0.1 until exactly NUM_OBJECTS = 36
    boxes survive (data_prepare.py:226-232);
  * boxes rescaled back to the raw image size (detector_postprocess).

NCHW throughout. A batch is a zero-padded canvas [B, 3, H, W] with each
image's (h, w): anchors centred beyond an image's extent are suppressed,
so the padding never proposes boxes. Outputs have static shapes
(POST_NMS_TOPK rows, NUM_OBJECTS slots with a validity mask), as in the
JAX package.

Precision: fp32. The convolutions run with cuDNN's TF32 off, set for the
extractor's calls alone (`torch.backends.cudnn.flags`); the two dense
layers follow torch's matmul setting, which is full fp32 unless a caller
changed it. The discrete steps (top-k, both NMS passes, the sweep) are
exact on any device given the same continuous inputs: top-k is a stable
descending sort (ties to the lower index, as `jax.lax.top_k`).

No Pallas kernel lies on this path in the JAX package (k3m_tpu/vision
computes everything in plain JAX), and none of the port's kernels does.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import pickle
import re
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from k3m_tpu_torch.device import resolve_device
from k3m_tpu_torch.vision import boxes as box_lib
from k3m_tpu_torch.vision.resnet import Res5Head, ResNet101C4Backbone
from k3m_tpu_torch.vision.roi import roi_align, roi_pool

logger = logging.getLogger(__name__)

NUM_OBJECTS = 36          # reference 2_generate_tsv_ali.py:27
NUM_CLASSES = 1600        # VG
PIXEL_MEAN_BGR = (103.530, 116.280, 123.675)  # detectron2 caffe default
ANCHOR_SIZES = (32, 64, 128, 256, 512)
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
STRIDE = 16
PRE_NMS_TOPK = 6000
POST_NMS_TOPK = 300       # data_prepare.py:264
RPN_NMS_THRESH = 0.7
SCORE_THRESH = 0.2        # data_prepare.py:266
MIN_SIZE_TEST = 600
MAX_SIZE_TEST = 1000
SELECT_CANDIDATES = 2048
NMS_SWEEP = (0.5, 0.6, 0.7, 0.8, 0.9)
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


# ------------------------------------------------------------------ model

class RPNHead(nn.Module):
    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feat):
        t = F.relu(self.conv(feat))
        return self.objectness_logits(t), self.anchor_deltas(t)


class RPN(nn.Module):
    """detectron2's `proposal_generator` (holds `rpn_head`)."""

    def __init__(self, channels: int, num_anchors: int):
        super().__init__()
        self.rpn_head = RPNHead(channels, num_anchors)


class BoxPredictor(nn.Module):
    """cls_score (C+1) and class-specific box deltas (4C) on the 2048-d
    mean-pooled res5 features."""

    def __init__(self, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.cls_score = nn.Linear(2048, num_classes + 1)
        self.bbox_pred = nn.Linear(2048, num_classes * 4)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


class ROIHeads(nn.Module):
    """detectron2's `roi_heads` of a C4 model: res5 and the predictor."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.res5 = Res5Head()
        self.box_predictor = BoxPredictor(num_classes)


def select_proposals(scores: torch.Tensor, proposals: torch.Tensor):
    """The RPN's discrete step: top PRE_NMS_TOPK scores (a stable sort),
    degenerate boxes to -inf, NMS at RPN_NMS_THRESH into POST_NMS_TOPK
    slots. scores [B, A], proposals [B, A, 4] -> (boxes [B, 300, 4],
    valid [B, 300])."""
    k = min(PRE_NMS_TOPK, scores.shape[-1])
    top_scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[..., :k], order[..., :k]
    top_boxes = proposals.gather(-2, top_idx[..., None].expand(*top_idx.shape, 4))
    wh_ok = (((top_boxes[..., 2] - top_boxes[..., 0]) > 0)
             & ((top_boxes[..., 3] - top_boxes[..., 1]) > 0))
    top_scores = torch.where(wh_ok, top_scores, -math.inf)
    idx, valid = box_lib.nms_fixed(top_boxes, top_scores, RPN_NMS_THRESH,
                                   POST_NMS_TOPK)
    return top_boxes.gather(-2, idx[..., None].expand(*idx.shape, 4)), valid


class FasterRCNN(nn.Module):
    """R101-C4 Faster R-CNN; module names are detectron2's
    (`backbone.res4.7.conv2`, `proposal_generator.rpn_head.objectness_logits`,
    `roi_heads.res5.0.shortcut`, `roi_heads.box_predictor.cls_score`).

    `forward(images, image_hw)` runs the stages in order; each is a method,
    so that a caller can hold one stage apart (chip_smoke.py does, card
    against CPU). `hook(stage)`, where given, is called after each stage:
    backbone, rpn, proposal_nms, roi_pool, res5, predictor."""

    def __init__(self, num_classes: int = NUM_CLASSES, pooler: str = "roi_pool"):
        super().__init__()
        if pooler not in ("roi_pool", "roi_align"):
            raise ValueError(f"unknown pooler {pooler!r}")
        self.num_classes = num_classes
        self.pooler = pooler
        self.backbone = ResNet101C4Backbone()
        self.proposal_generator = RPN(1024, len(ANCHOR_SIZES) * len(ANCHOR_RATIOS))
        self.roi_heads = ROIHeads(num_classes)
        self._anchors: Dict[tuple, torch.Tensor] = {}

    def anchors(self, fh: int, fw: int, device) -> torch.Tensor:
        key = (fh, fw, str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(box_lib.generate_anchors(
                fh, fw, STRIDE, ANCHOR_SIZES, ANCHOR_RATIOS)).to(device)
        return self._anchors[key]

    def rpn_outputs(self, feat):
        """feat [B, 1024, fh, fw] -> objectness [B, fh*fw*A] and deltas
        [B, fh*fw*A, 4], both in the anchors' (h, w, a) order: the NCHW
        channels are moved last before the reshape, so each delta stays
        with its anchor (channel a*4 + j is anchor a's coordinate j)."""
        logits, deltas = self.proposal_generator.rpn_head(feat)
        B = feat.shape[0]
        return (logits.permute(0, 2, 3, 1).reshape(B, -1),
                deltas.permute(0, 2, 3, 1).reshape(B, -1, 4))

    def decode_proposals(self, logits, deltas, image_hw, fh: int, fw: int):
        """Anchors + deltas -> boxes clipped to each image; anchors centred
        beyond an image's extent get a -inf score (a no-op for an image
        that fills its canvas)."""
        anchors = self.anchors(fh, fw, logits.device)
        h, w = image_hw[:, 0:1], image_hw[:, 1:2]               # [B, 1]
        proposals = box_lib.clip_boxes(box_lib.apply_deltas(deltas, anchors),
                                       h, w)
        ctr_x = (anchors[:, 0] + anchors[:, 2]) * 0.5
        ctr_y = (anchors[:, 1] + anchors[:, 3]) * 0.5
        inside = (ctr_x <= w) & (ctr_y <= h)
        return torch.where(inside, logits, -math.inf), proposals

    def pool(self, feat, prop_boxes):
        if self.pooler == "roi_pool":
            return roi_pool(feat, prop_boxes, 1.0 / STRIDE, output_size=14)
        return roi_align(feat, prop_boxes, 1.0 / STRIDE, output_size=14,
                         sampling_ratio=2)

    def box_features(self, pooled):
        """[B, N, 1024, 14, 14] -> res5, mean over the 7x7 cells ->
        [B, N, 2048]."""
        B, N = pooled.shape[:2]
        return self.roi_heads.res5(pooled.flatten(0, 1)).mean(dim=(2, 3)).view(B, N, -1)

    def predict(self, features, prop_boxes, image_hw):
        """-> class probabilities [B, N, C+1] and class-specific boxes
        [B, N, C, 4], clipped to each image."""
        scores, deltas = self.roi_heads.box_predictor(features)
        probs = torch.softmax(scores, dim=-1)
        B, N = features.shape[:2]
        per_class = box_lib.apply_deltas(deltas.view(B, N, self.num_classes, 4),
                                         prop_boxes[:, :, None, :], weights=BOX_WEIGHTS)
        per_class = box_lib.clip_boxes(per_class, image_hw[:, 0, None, None],
                                       image_hw[:, 1, None, None])
        return probs, per_class

    def forward(self, images, image_hw, hook: Optional[Callable[[str], None]] = None):
        """images [B, 3, H, W] mean-subtracted BGR (zero padding);
        image_hw [B, 2] float, each image's (h, w) inside the canvas.
        Returns proposal_boxes [B, 300, 4], proposal_valid [B, 300],
        features [B, 300, 2048], probs [B, 300, C+1], boxes
        [B, 300, C, 4]."""
        mark = hook or (lambda stage: None)
        feat = self.backbone(images)
        mark("backbone")
        fh, fw = feat.shape[2:]
        logits, deltas = self.rpn_outputs(feat)
        scores, proposals = self.decode_proposals(logits, deltas, image_hw, fh, fw)
        mark("rpn")
        prop_boxes, prop_valid = select_proposals(scores, proposals)
        mark("proposal_nms")
        pooled = self.pool(feat, prop_boxes)
        mark("roi_pool")
        features = self.box_features(pooled)
        mark("res5")
        probs, per_class = self.predict(features, prop_boxes, image_hw)
        mark("predictor")
        return dict(proposal_boxes=prop_boxes, proposal_valid=prop_valid,
                    features=features, probs=probs, boxes=per_class)


@contextlib.contextmanager
def inference():
    """No autograd, cuDNN convolutions in full fp32 (TF32 off); the
    caller's other cuDNN settings stay."""
    with torch.inference_mode(), torch.backends.cudnn.flags(
            enabled=True, benchmark=torch.backends.cudnn.benchmark,
            deterministic=torch.backends.cudnn.deterministic, allow_tf32=False):
        yield


# ------------------------------------------------------ inference pipeline

def resize_shape(h: int, w: int, min_size=MIN_SIZE_TEST, max_size=MAX_SIZE_TEST):
    """detectron2 ResizeShortestEdge.get_transform's output size,
    transcribed exactly as the JAX package has it: pin the short side to
    min_size, then rescale BOTH computed sides if the long side exceeds
    max_size (the two-step float product rounds differently from a single
    h*scale in ~1px edge cases)."""
    scale = min_size * 1.0 / min(h, w)
    if h < w:
        nh, nw = min_size, scale * w
    else:
        nh, nw = scale * h, min_size
    if max(nh, nw) > max_size:
        scale = max_size * 1.0 / max(nh, nw)
        nh = nh * scale
        nw = nw * scale
    return int(nh + 0.5), int(nw + 0.5)


def resize_shortest_edge(image: np.ndarray, min_size=MIN_SIZE_TEST,
                         max_size=MAX_SIZE_TEST, device="cpu") -> torch.Tensor:
    """uint8 [H, W, 3] -> float32 [3, nh, nw] on `device`: one upload of the
    uint8 image, then a bilinear resize there (half-pixel centres, no
    antialias: cv2.resize's INTER_LINEAR, which the JAX package runs on the
    host). The resize runs in float64: in float32, F.interpolate's source
    coordinates (up to 1000 px) carry rounding of ~1e-4 px, which moves a
    value by up to 0.01 between neighbours 255 apart; in float64 it is
    within 3e-5 of cv2's on the 0-255 scale."""
    nh, nw = resize_shape(image.shape[0], image.shape[1], min_size, max_size)
    x = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    x = x.permute(2, 0, 1)[None].double()
    return F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                         antialias=False)[0].float()


def preprocess(image: np.ndarray, device, min_size=MIN_SIZE_TEST,
               max_size=MAX_SIZE_TEST) -> torch.Tensor:
    """uint8 BGR [H, W, 3] -> resized, mean-subtracted [3, nh, nw]."""
    x = resize_shortest_edge(image, min_size, max_size, device)
    mean = torch.tensor(PIXEL_MEAN_BGR, dtype=torch.float32, device=x.device)
    return x - mean[:, None, None]


def _select_instances(outputs: Dict[str, torch.Tensor], valid: torch.Tensor):
    """fast_rcnn_inference_single_image with the adaptive NMS sweep
    (data_prepare.py:226-232), static shapes, per image of the batch.

    NMS over all N*C class-box pairs would build an (N*C)^2 IoU matrix;
    detectron2 first drops the scores below SCORE_THRESH (a dynamic shape).
    As in the JAX package, the top SELECT_CANDIDATES scores stand in for
    that (K >> NUM_OBJECTS, so the kept set is the same). The five sweep
    thresholds run as five passes of one loop over one IoU matrix; the
    first threshold that keeps exactly NUM_OBJECTS wins, else the last.
    The selected rows' features and probabilities are gathered here, so
    only NUM_OBJECTS rows per image leave the device."""
    probs_all = outputs["probs"]                             # [B, N, C+1]
    probs = probs_all[..., :-1]                              # drop background
    B, N, C = probs.shape
    flat = torch.where(valid[..., None], probs, 0.0).reshape(B, N * C)
    flat = torch.where(flat > SCORE_THRESH, flat, -math.inf)
    flat_boxes = outputs["boxes"].reshape(B, N * C, 4)
    K = min(SELECT_CANDIDATES, N * C)
    cand = torch.sort(flat, dim=-1, descending=True, stable=True)[1][:, :K]
    scores = flat.gather(1, cand)
    cand_boxes = flat_boxes.gather(1, cand[..., None].expand(B, K, 4))
    class_ids, row_ids = cand % C, cand // C

    S = len(NMS_SWEEP)
    idx, ok = box_lib.batched_nms_fixed(cand_boxes, scores, class_ids, NMS_SWEEP,
                                        NUM_OBJECTS)           # [B, S, 36]
    ok = ok & (scores.gather(1, idx.reshape(B, -1)).view(B, S, -1) > SCORE_THRESH)
    exact = ok.sum(dim=-1) == NUM_OBJECTS                      # [B, S]
    pick = torch.where(exact.any(dim=-1), exact.to(torch.int8).argmax(dim=-1), S - 1)
    take = pick.view(B, 1, 1).expand(B, 1, NUM_OBJECTS)
    idx = idx.gather(1, take)[:, 0]
    ok = ok.gather(1, take)[:, 0]
    sel_rows = row_ids.gather(1, idx)
    features = outputs["features"]
    return dict(boxes=cand_boxes.gather(1, idx[..., None].expand(B, NUM_OBJECTS, 4)),
                scores=scores.gather(1, idx), rows=sel_rows, valid=ok,
                features=features.gather(1, sel_rows[..., None].expand(
                    B, NUM_OBJECTS, features.shape[-1])),
                cls_prob=probs_all.gather(1, sel_rows[..., None].expand(
                    B, NUM_OBJECTS, C + 1)))


def _finalize_selection(sel: Dict, raw_h: int, raw_w: int, ih: float,
                        iw: float) -> Optional[Dict]:
    """Host-side tail of extraction for one image: valid rows first, sliced
    to the detected count, boxes rescaled to the raw image size
    (detector_postprocess), NaN guard (ref data_prepare.py:244-245)."""
    n = int(sel["valid"].sum())
    if n == 0:
        return None
    # valid rows first, by the JAX package's very call: numpy's default
    # (unstable) argsort, so that both write the same records
    order = np.argsort(~sel["valid"])
    boxes = np.asarray(sel["boxes"])[order][:n].copy()
    feats = np.asarray(sel["features"])[order][:n]
    probs = np.asarray(sel["cls_prob"])[order][:n]
    scale_x, scale_y = raw_w / iw, raw_h / ih
    boxes = boxes * np.array([scale_x, scale_y, scale_x, scale_y], np.float32)
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, raw_w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, raw_h)
    if np.isnan(feats).any():
        return None
    return dict(image_h=raw_h, image_w=raw_w, num_boxes=n, boxes=boxes,
                features=feats, cls_prob=probs)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _to_host(sel: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in sel.items()}


def extract_rois(model: FasterRCNN, raw_image_bgr: np.ndarray,
                 min_size: int = MIN_SIZE_TEST, max_size: int = MAX_SIZE_TEST
                 ) -> Optional[Dict]:
    """One image, unpadded (get_detections_from_image,
    data_prepare.py:183-258). raw_image_bgr: uint8 [H, W, 3] BGR."""
    raw_h, raw_w = raw_image_bgr.shape[:2]
    device = _device_of(model)
    with inference():
        image = preprocess(raw_image_bgr, device, min_size, max_size)
        ih, iw = image.shape[1:]
        hw = torch.tensor([[ih, iw]], dtype=torch.float32, device=device)
        outputs = model(image[None], hw)
        sel = _to_host(_select_instances(outputs, outputs["proposal_valid"]))
    return _finalize_selection({k: v[0] for k, v in sel.items()}, raw_h, raw_w,
                               float(ih), float(iw))


def image_path(item: Dict, image_dir: Optional[str]) -> str:
    name = item.get("item_image_name") or item.get("image_url", "").split("/")[-1]
    return os.path.join(image_dir or "", name)


class BatchedExtractor:
    """Size-bucketed, batched RoI extraction.

    Images are resized on the device, placed in a zero canvas whose sides
    are rounded up to multiples of `bucket` px, and run `batch_size` to a
    call through the network and the selection: one device->host copy of
    NUM_OBJECTS rows per image. Unlike the JAX package, which pads every
    call to `batch_size` images so that few programs compile, a call holds
    only the images of its group: each image's result depends on its own
    canvas alone.

    Padding parity: the canvas is zero after mean subtraction, detectron2's
    batched `ImageList.from_tensors` padding, and anchors centred beyond an
    image are score-suppressed; what remains between the batched and the
    per-image path is the convolutions' border halo.

    `fallbacks` counts the images that the per-image path extracted after
    a batch failed (the reference's per-image tolerance); `flush_seconds`
    holds (images, host seconds) per flush of `map`, image reading
    included; `stage_hook(stage)`, where set, is called after each stage
    (`preprocess`, FasterRCNN.forward's stages, `selection`)."""

    def __init__(self, model: FasterRCNN, batch_size: int = 4, bucket: int = 200,
                 min_size: int = MIN_SIZE_TEST, max_size: int = MAX_SIZE_TEST):
        self.model = model
        self.batch_size = batch_size
        self.bucket = bucket
        self.min_size = min_size
        self.max_size = max_size
        self.fallbacks = 0
        self.flush_seconds: list = []
        self.stage_hook: Optional[Callable[[str], None]] = None

    def _canvas_hw(self, ih: int, iw: int) -> tuple:
        b = self.bucket
        return (-(-ih // b) * b, -(-iw // b) * b)

    def extract_many(self, raw_images_bgr) -> list:
        """[uint8 BGR HxWx3 | None, ...] -> [detection dict | None, ...] in
        order."""
        device = _device_of(self.model)
        mark = self.stage_hook or (lambda stage: None)
        results: list = [None] * len(raw_images_bgr)
        with inference():
            prepped, groups = {}, {}
            for i, im in enumerate(raw_images_bgr):
                if im is None:
                    continue
                r = preprocess(im, device, self.min_size, self.max_size)
                prepped[i] = (r, im.shape[0], im.shape[1])
                groups.setdefault(self._canvas_hw(*r.shape[1:]), []).append(i)
            B = self.batch_size
            for (ch, cw), idxs in groups.items():
                for s in range(0, len(idxs), B):
                    chunk = idxs[s:s + B]
                    canvas = torch.zeros(len(chunk), 3, ch, cw, device=device)
                    hws = []
                    for j, i in enumerate(chunk):
                        img = prepped[i][0]
                        canvas[j, :, :img.shape[1], :img.shape[2]] = img
                        hws.append(img.shape[1:])
                    hw = torch.tensor(hws, dtype=torch.float32, device=device)
                    mark("preprocess")
                    outputs = self.model(canvas, hw, hook=self.stage_hook)
                    sel = _select_instances(outputs, outputs["proposal_valid"])
                    mark("selection")
                    sel = _to_host(sel)
                    for j, i in enumerate(chunk):
                        ih, iw = hws[j]
                        results[i] = _finalize_selection(
                            {k: v[j] for k, v in sel.items()}, prepped[i][1],
                            prepped[i][2], float(ih), float(iw))
        return results

    def map(self, items, image_dir: Optional[str] = None):
        """Generator over (item, detection-or-None) in input order, reading
        images from disk and batching device work. A batch that fails falls
        back to the per-image path, and an image that fails there too gets
        None (ref data_prepare.py:360-366); both are logged and counted."""
        buf = []

        def flush():
            t0 = time.perf_counter()
            images = [read_image(image_path(it, image_dir)) for it in buf]
            try:
                dets = self.extract_many(images)
            except Exception:
                logger.exception("batched extraction failed; falling back "
                                 "to per-image")
                dets = []
                for im in images:
                    self.fallbacks += im is not None
                    try:
                        dets.append(None if im is None else extract_rois(
                            self.model, im, self.min_size, self.max_size))
                    except Exception:
                        logger.exception("extraction failed")
                        dets.append(None)
                logger.warning("%d images so far through the per-image fallback",
                               self.fallbacks)
            self.flush_seconds.append((len(buf), time.perf_counter() - t0))
            out = list(zip(list(buf), dets))
            buf.clear()
            return out

        for item in items:
            buf.append(item)
            if len(buf) >= self.batch_size:
                yield from flush()
        if buf:
            yield from flush()


# ------------------------------------------------------------ image files

def _read_pnm(path: str) -> np.ndarray:
    """Binary PPM (P6) or PGM (P5), maxval 255 -> BGR uint8 [H, W, 3], as
    cv2.imread gives it."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
        if fields[0] not in (b"P5", b"P6"):
            raise ValueError(
                f"{path}: not a binary PPM/PGM; reading other image formats "
                "needs cv2 (opencv-python), which is not installed")
    width, height, maxval = (int(v) for v in fields[1:])
    if maxval != 255:
        raise ValueError(f"{path}: maxval {maxval}; without cv2 only 8-bit "
                         "PPM/PGM (maxval 255) is read")
    channels = 3 if fields[0] == b"P6" else 1
    raster = np.frombuffer(data, np.uint8, count=width * height * channels,
                           offset=pos + 1).reshape(height, width, channels)
    if channels == 1:
        return np.repeat(raster, 3, axis=2)
    return np.ascontiguousarray(raster[:, :, ::-1])


def read_image(path: str) -> Optional[np.ndarray]:
    """BGR uint8 [H, W, 3], or None where the file does not exist:
    `cv2.imread` where cv2 imports (as the JAX package reads), else binary
    PPM/PGM by numpy; any other format then raises, naming cv2."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        return cv2.imread(path)
    if not os.path.exists(path):
        return None
    return _read_pnm(path)


# ----------------------------------------------------------- weight loading

def load_caffe_pkl(path: str) -> Dict[str, np.ndarray]:
    """Load a detectron2 caffe pkl ({'model': {name: ndarray}})."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    model = data.get("model", data)
    return {k: np.asarray(v) for k, v in model.items()
            if isinstance(v, np.ndarray) or hasattr(v, "shape")}


def _fold_bn(sd, prefix):
    """Fold detectron2 FrozenBN (weight, bias, running_mean, running_var)
    into (scale, bias), eps 1e-5."""
    g = sd[f"{prefix}.norm.weight"]
    b = sd[f"{prefix}.norm.bias"]
    mean = sd.get(f"{prefix}.norm.running_mean", np.zeros_like(g))
    var = sd.get(f"{prefix}.norm.running_var", np.ones_like(g))
    scale = g / np.sqrt(var + 1e-5)
    return scale, b - mean * scale


# Source keys a strict caffe-pkl conversion may leave unconsumed:
# bookkeeping buffers, preprocessing constants, and classification-head
# leftovers some detectron2 exports carry. Anything else unconsumed means
# a renamed or missed weight and fails loudly.
_CAFFE_IGNORABLE = re.compile(
    r"num_batches_tracked|pixel_mean|pixel_std|anchor_generator"
    r"|cell_anchors|stem\.fc|fc1000|\.momentum$")


class _TrackedSD(dict):
    """dict that records which keys the converter read."""

    def __init__(self, d):
        super().__init__(d)
        self.used = set()

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        self.used.add(k)
        return super().get(k, default)


def convert_caffe_weights(sd: Dict[str, np.ndarray], model: FasterRCNN,
                          strict: bool = True) -> Dict[str, torch.Tensor]:
    """detectron2 R101-C4 tensors -> the model's state dict. The names are
    the model's own, so the mapping is the identity but for the BatchNorms,
    folded into each FrozenBN's scale and bias.

    strict (default; K3M_CAFFE_LENIENT=1 turns it off): a source tensor
    that nothing consumed (a renamed key, layout drift in a real
    faster_rcnn_from_caffe.pkl) raises, as does a model weight with no
    source. Lenient, only the leftovers pass: a missing weight raises
    KeyError, as in the JAX package."""
    strict = strict and not os.environ.get("K3M_CAFFE_LENIENT")
    sd = _TrackedSD(sd)
    out, missing = {}, []
    for name in model.state_dict():
        try:
            if name.endswith(".norm.scale"):
                scale, bias = _fold_bn(sd, name[:-len(".norm.scale")])
                out[name] = scale
                out[name[:-len("scale")] + "bias"] = bias
            elif not name.endswith(".norm.bias"):
                out[name] = sd[name]
        except KeyError as e:
            missing.append(e.args[0])
    problems = []
    leftovers = sorted(k for k in sd if k not in sd.used
                       and not _CAFFE_IGNORABLE.search(k))
    if strict and leftovers:
        problems.append(f"{len(leftovers)} source tensors never consumed: "
                        f"{leftovers[:6]}")
    if missing:
        if not strict:
            raise KeyError(missing[0])
        problems.append(f"{len(missing)} model weights never written: {missing[:6]}")
    if problems:
        raise ValueError("strict caffe-pkl conversion failed (set "
                         "K3M_CAFFE_LENIENT=1 to override): " + "; ".join(problems))
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in out.items()}


def synthetic_caffe_state_dict(num_classes: int = NUM_CLASSES, seed: int = 0
                               ) -> Dict[str, np.ndarray]:
    """Seeded random weights in the bottom-up-attention pkl's layout
    (detectron2 names, conv [out, in, kh, kw], each BatchNorm as weight,
    bias, running_mean, running_var), for runs without the published file
    (the repository holds no detector weights).

    Random weights must still make the selection run, or every image would
    fall back to the zero-box record. So:
      * convolutions He-normal (std sqrt(2 / fan_in)); BatchNorm statistics
        random (mean N(0, 0.1), var U(0.5, 1.5), beta N(0, 0.1)); gamma 1/64
        on the stem, whose input is raw pixels less their mean (~60 rms),
        0.2 on each block's conv3, 1 elsewhere: activations stay O(1)
        through the 33 residual blocks;
      * the RPN: objectness weights N(0, 0.01), box deltas N(0, 1e-4), so
        that proposals stay near their anchors and rarely degenerate;
      * the predictor: box deltas N(0, 1e-3); class weights N(0, 0.002) and
        bias 0, but for min(3, C) classes whose bias log(C + 1) + 2 gives
        each a probability near 0.3, above SCORE_THRESH on most RoIs, so
        that the sweep finds its NUM_OBJECTS boxes."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):             # names and shapes only
        model = FasterRCNN(num_classes=num_classes)
    sd: Dict[str, np.ndarray] = {}

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(std))

    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith(".norm.scale"):
            prefix = name[:-len(".scale")]
            c = shape[0]
            gamma = 1.0 / 64 if prefix.startswith("backbone.stem") else (
                0.2 if prefix.endswith("conv3.norm") else 1.0)
            sd[f"{prefix}.weight"] = np.full(c, gamma, np.float32)
            sd[f"{prefix}.bias"] = normal(c, 0.1)
            sd[f"{prefix}.running_mean"] = normal(c, 0.1)
            sd[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        elif name.endswith(".norm.bias"):
            continue
        elif name.endswith(".weight") and len(shape) == 4:
            std = {"objectness_logits": 0.01, "anchor_deltas": 1e-4}.get(
                name.split(".")[-2], math.sqrt(2.0 / np.prod(shape[1:])))
            sd[name] = normal(shape, std)
        elif name.endswith(".weight"):
            sd[name] = normal(shape, 0.002 if "cls_score" in name else 1e-3)
        else:
            sd[name] = np.zeros(shape, np.float32)
    hot = np.arange(min(3, num_classes))
    sd["roi_heads.box_predictor.cls_score.bias"][hot] = math.log(num_classes + 1) + 2.0
    return sd


def build_model(weights_path: Optional[str] = None, device="cuda",
                num_classes: int = NUM_CLASSES) -> FasterRCNN:
    """The detector on `device` (default the card; see resolve_device),
    with the caffe pkl's weights where the file exists, else the seeded
    synthetic ones (features then mean nothing)."""
    dev = resolve_device(device)
    model = FasterRCNN(num_classes=num_classes)
    if weights_path and os.path.exists(weights_path):
        sd = convert_caffe_weights(load_caffe_pkl(weights_path), model)
        logger.info("loaded caffe weights from %s", weights_path)
    else:
        logger.warning("no caffe pkl provided: the extractor runs with seeded "
                       "random weights (features are not meaningful)")
        sd = convert_caffe_weights(synthetic_caffe_state_dict(num_classes), model)
    model.load_state_dict(sd, strict=True)
    return model.to(dev).eval()


def make_batched_extractor(weights_path: Optional[str] = None, batch_size: int = 4,
                           bucket: int = 200, device="cuda") -> BatchedExtractor:
    """Batched extractor: `.extract_many(images)` / `.map(items, image_dir)`."""
    return BatchedExtractor(build_model(weights_path, device), batch_size=batch_size,
                            bucket=bucket)


def make_extractor(image_dir: Optional[str], weights_path: Optional[str] = None,
                   device="cuda"):
    """item -> detection dict (or None), one image at a time."""
    model = build_model(weights_path, device)

    def extractor(item):
        path = image_path(item, image_dir)
        image = read_image(path)
        if image is None:
            return None
        try:
            return extract_rois(model, image)
        except Exception as e:   # per-image error tolerance (ref :360-366)
            logger.error("extraction failed for %s: %s", path, e)
            return None

    return extractor
