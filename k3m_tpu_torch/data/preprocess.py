"""Per-pair preprocessing for item alignment: tokenization, pv span
indexing, RoI padding and locations, fixed-shape padding.

The port's own copy of the pair path of k3m_tpu/data/preprocess.py
(reference K3MPreprocessBatch, concept_cap_dataset_struc.py:936-1263):

  * zero-box fallback image (ref :571-576)
  * box IoU with the +1 pixel convention (ref :40-77)
  * 5-d normalized location with the area in slot 4 (ref :586-595)
  * pv span extraction index_p/index_v as [begin, end] position pairs,
    capped at max_num_pv and keyed on raw ids 131=':' 132=';'
    (ref index_pv :785-813)
  * padding/truncation to max_seq_len / max_seq_len_pv / max_region_len
    (ref convert_example_to_features :654-747)
  * the batch-level global image token; the finetune loader divides the
    feature sum by num_boxes (ref post_process :272-294)

The pretraining path (MLM and RoI masking) comes with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from k3m_tpu_torch.tokenization import WordPieceTokenizer

PV_COLON_ID = 131   # ':' in the bert-base-chinese vocab layout
PV_SEMI_ID = 132    # ';'


def box_iou(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Pairwise IoU with the reference's +1 pixel convention (ref :40-77)."""
    area_b = ((boxes_b[:, 2] - boxes_b[:, 0] + 1)
              * (boxes_b[:, 3] - boxes_b[:, 1] + 1))[None, :]
    area_a = ((boxes_a[:, 2] - boxes_a[:, 0] + 1)
              * (boxes_a[:, 3] - boxes_a[:, 1] + 1))[:, None]
    iw = (np.minimum(boxes_a[:, None, 2], boxes_b[None, :, 2])
          - np.maximum(boxes_a[:, None, 0], boxes_b[None, :, 0]) + 1).clip(min=0)
    ih = (np.minimum(boxes_a[:, None, 3], boxes_b[None, :, 3])
          - np.maximum(boxes_a[:, None, 1], boxes_b[None, :, 1]) + 1).clip(min=0)
    union = area_a + area_b - iw * ih
    return iw * ih / union


def index_pv(token_ids: List[int], max_num_pv: int
             ) -> Tuple[List[List[int]], List[List[int]]]:
    """Property/value span boundary pairs (ref index_pv :785-813).

    For tokens [CLS] p p : v v ; p : v ; ... returns
      index_p = [[pv_begin, pos_of_':'], ...]
      index_v = [[pos_of_':' + 1, pos_of_';'], ...]
    """
    idx131 = [i for i, t in enumerate(token_ids) if t == PV_COLON_ID]
    idx132 = [i for i, t in enumerate(token_ids) if t == PV_SEMI_ID]
    if len(idx132) == len(idx131) - 1:
        idx131 = idx131[:-1]
    elif len(idx132) != len(idx131):
        idx131, idx132 = [], []
    index_p, index_v = [], []
    pv_begin = 1
    for a, b in zip(idx131, idx132):
        index_p.append([pv_begin, a])
        index_v.append([a + 1, b])
        pv_begin = b + 1
        if len(index_p) >= max_num_pv:
            break
    return index_p, index_v


@dataclasses.dataclass
class ShapeSpec:
    max_seq_len: int = 50
    max_seq_len_pv: int = 256
    max_num_pv: int = 30
    max_region_len: int = 36
    v_feature_size: int = 2048
    v_target_size: int = 1601
    v_loc_size: int = 5


class PairPreprocessor:
    """One alignment pair record -> twin fixed-shape features, no masking
    (ref K3MPreprocessBatch :936-1263). The RoI target is the class
    distribution (`cls_prob`), as under the default visual_target 0."""

    def __init__(self, tokenizer: WordPieceTokenizer, shapes: ShapeSpec):
        self.tokenizer = tokenizer
        self.shapes = shapes

    def image_processing(self, image_h, image_w, num_boxes, boxes, features,
                         cls_prob):
        """Pad RoIs to max_region_len and build normalized 5-d locations
        (ref :570-601); returns (feat, target, loc, num_boxes, overlaps)."""
        s = self.shapes
        if num_boxes <= 0:  # zero-box fallback (ref :571-576)
            image_h, image_w, num_boxes = 800, 800, 1
            boxes = np.array([[0.1, 0.1, image_w - 0.1, image_h - 0.1]],
                             dtype=np.float32)
            features = np.zeros((1, s.v_feature_size), dtype=np.float32)
            cls_prob = np.zeros((1, s.v_target_size), dtype=np.float32)
        num_boxes = int(min(num_boxes, s.max_region_len))
        boxes = np.asarray(boxes, dtype=np.float32)[:num_boxes]
        features = np.asarray(features, dtype=np.float32)[:num_boxes]
        overlaps = box_iou(boxes, boxes)
        feat = np.zeros((s.max_region_len, s.v_feature_size), dtype=np.float32)
        target = np.zeros((s.max_region_len, s.v_target_size), dtype=np.float32)
        loc = np.zeros((s.max_region_len, s.v_loc_size), dtype=np.float32)
        feat[:num_boxes] = features
        if cls_prob is not None:
            target_src = np.asarray(cls_prob, dtype=np.float32)[:num_boxes]
            target[:num_boxes, :target_src.shape[1]] = target_src
        loc[:num_boxes, :4] = boxes
        loc[:, 4] = ((loc[:, 3] - loc[:, 1]) * (loc[:, 2] - loc[:, 0])
                     / (float(image_w) * float(image_h)))
        loc[:, 0] /= float(image_w)
        loc[:, 1] /= float(image_h)
        loc[:, 2] /= float(image_w)
        loc[:, 3] /= float(image_h)
        return feat, target, loc, num_boxes, overlaps

    @staticmethod
    def _pad_text(ids: List[int], max_len: int):
        n = len(ids)
        pad = max_len - n
        return dict(ids=np.array(list(ids) + [0] * pad, np.int32),
                    mask=np.array([1] * n + [0] * pad, np.int32),
                    seg=np.zeros(max(n, max_len), np.int32))

    def _one(self, record: Dict) -> Dict[str, np.ndarray]:
        s = self.shapes
        tok = self.tokenizer
        feat, target, loc, num_boxes, _ = self.image_processing(
            record.get("image_h", 0), record.get("image_w", 0),
            record.get("num_boxes", 0), record.get("boxes"),
            record.get("features"), record.get("cls_prob"))
        tokens = tok.encode(record["title"])[: s.max_seq_len - 2]
        tokens_pv = tok.encode(record["pv"])[: s.max_seq_len_pv - 2]
        tokens = tok.add_special_tokens_single_sentence(tokens)
        tokens_pv = tok.add_special_tokens_single_sentence(tokens_pv)
        idx_p, idx_v = index_pv(tokens_pv, s.max_num_pv)
        idx_p += [[0, 0]] * (s.max_num_pv - len(idx_p))
        idx_v += [[0, 0]] * (s.max_num_pv - len(idx_v))
        t = self._pad_text(tokens, s.max_seq_len)
        p = self._pad_text(tokens_pv, s.max_seq_len_pv)
        image_mask = [1] * num_boxes + [0] * (s.max_region_len - num_boxes)
        return dict(
            item_id=str(record.get("item_id", "")),
            num_boxes=np.int32(num_boxes),
            input_ids=t["ids"], input_mask=t["mask"], segment_ids=t["seg"],
            input_ids_pv=p["ids"], input_mask_pv=p["mask"],
            segment_ids_pv=p["seg"],
            index_p=np.array(idx_p, np.int32).reshape(s.max_num_pv, 2),
            index_v=np.array(idx_v, np.int32).reshape(s.max_num_pv, 2),
            image_feat=feat, image_loc=loc, image_target=target,
            image_mask=np.array(image_mask, np.int32),
        )

    def __call__(self, pair: Dict) -> Dict[str, object]:
        return dict(
            label=np.float32(pair["label"]),
            item1=self._one(pair["item1"]),
            item2=self._one(pair["item2"]),
        )


def add_global_image_token(image_feat: np.ndarray, image_loc: np.ndarray,
                           image_mask: np.ndarray,
                           divisor: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Prepend the global image token: the feature sum over regions divided
    by `divisor` [B, 1], with location [0, 0, 1, 1, 1] (finetune ref
    :272-294 divides by num_boxes)."""
    B, R, D = image_feat.shape
    # preallocate and assign blocks: numpy's axis-1 concatenate is far
    # slower at [B, 37, 2048]
    feat = np.empty((B, R + 1, D), np.float32)
    np.sum(image_feat, axis=1, out=feat[:, 0])
    feat[:, 0] /= divisor
    feat[:, 1:] = image_feat
    loc = np.empty((B, R + 1, image_loc.shape[-1]), np.float32)
    loc[:, 0] = np.array([0, 0, 1, 1, 1], np.float32)
    loc[:, 1:] = image_loc
    mask = np.empty((B, R + 1), image_mask.dtype)
    mask[:, 0] = 1
    mask[:, 1:] = image_mask
    return feat, loc, mask
