"""The model inputs of the items a batch holds, worked out again from the
benchmark's own draws (lib/synthetic.py), and the judgement of the
program's staged batches against them: token ids, pv spans and image
locations exactly, image features within bf16 rounding and class
probabilities within fp16 rounding (the `fp` wire's forms; the `exact`
wire's fp32 forms pass too). A pretraining batch's masking is the
program's random choice: it is judged (unmasked positions hold the items'
tokens, masked ones label them; a region's features are its own or, where
the region is a target, zero) and then taken as it is."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.lib import synthetic as S


def _pad(ids: List[int], n: int) -> np.ndarray:
    out = np.zeros(n, np.int64)
    out[:len(ids)] = ids
    return out


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().float().numpy()


def _fp16(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).astype(np.float16).astype(np.float32)


def _near(staged: np.ndarray, exact: np.ndarray, rounded: np.ndarray) -> np.ndarray:
    """Elements that are neither the exact value nor its rounded form."""
    return (staged != exact) & (staged != rounded)


def iou(boxes: np.ndarray) -> np.ndarray:
    b = boxes.astype(np.float32)
    area = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    iw = np.minimum(b[:, None, 2], b[None, :, 2]) - np.maximum(b[:, None, 0], b[None, :, 0]) + 1
    ih = np.minimum(b[:, None, 3], b[None, :, 3]) - np.maximum(b[:, None, 1], b[None, :, 1]) + 1
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    return inter / (area[:, None] + area[None, :] - inter)


def item_inputs(d: Dict, seq_len: int, pv_len: int, max_num_pv: int) -> Dict[str, np.ndarray]:
    """One item's unmasked model inputs (ids, masks, spans, image rows with
    the global token first: the mean of its 36 regions, location
    [0, 0, 1, 1, 1]; the regions' class probabilities, without it)."""
    t, p = S.title_ids(d), S.pv_ids(d, pv_len)
    ip, iv = S.pv_spans(p, max_num_pv)
    feat = np.concatenate([d["features"].mean(0, keepdims=True), d["features"]])
    loc = np.concatenate([np.array([[0, 0, 1, 1, 1]], np.float32), S.image_loc(d)])
    return dict(input_ids=_pad(t, seq_len), input_mask=(_pad(t, seq_len) != 0).astype(np.int64),
                segment_ids=np.zeros(seq_len, np.int64),
                input_ids_pv=_pad(p, pv_len), input_mask_pv=(_pad(p, pv_len) != 0).astype(np.int64),
                segment_ids_pv=np.zeros(pv_len, np.int64), index_p=ip, index_v=iv,
                image_feat=feat.astype(np.float32), image_loc=loc,
                image_target=d["cls_prob"].astype(np.float32),
                image_mask=np.ones(S.N_BOXES + 1, np.int64))


def _np(t):
    if isinstance(t, np.ndarray):
        return t.astype(np.float32) if t.dtype.kind == "f" else t.astype(np.int64)
    return t.float().numpy() if t.is_floating_point() else t.long().numpy()


def judge_item(staged: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> int:
    """Mismatching elements of one unmasked staged item (a pair's side)."""
    bad = 0
    for k in ("input_ids", "input_mask", "segment_ids", "input_ids_pv", "input_mask_pv",
              "segment_ids_pv", "index_p", "index_v", "image_mask"):
        bad += int((staged[k] != want[k]).sum())
    bad += int((np.abs(staged["image_loc"] - want["image_loc"]) > 1e-6).sum())
    f = staged["image_feat"]
    bad += int((np.abs(f - want["image_feat"]) > 2.0 ** -8 * np.abs(want["image_feat"]) + 1e-6).sum())
    return bad


def pair_inputs(seed: int, pairs, traffic) -> Dict:
    """The reference's inputs of the pairs `pairs` (item 2i and 2i + 1 and
    the label of pair i)."""
    shape = (traffic["max_seq_length"], traffic["max_seq_length_pv"], traffic["max_num_pv"])
    items = {side: [item_inputs(S.item_draws(seed, 2 * p + k), *shape) for p in pairs]
             for k, side in ((0, "item1"), (1, "item2"))}
    labels = np.array([S.pair_label(seed, p) for p in pairs], np.float32)
    stacked = {side: {k: np.stack([w[k] for w in ws]) for k in ws[0]}
               for side, ws in items.items()}
    return dict(label=labels, **stacked)


def judge_pairs(want: Dict, staged: Dict, rows) -> int:
    """Mismatching elements of a loader's pair batch (host arrays) at
    `rows` against the reference's inputs `want` of the same pairs."""
    bad = int((np.asarray(staged["label"])[rows] != want["label"]).sum())
    for side in ("item1", "item2"):
        for i, row in enumerate(rows):
            got = {k: _np(v[row]) for k, v in staged[side].items() if k != "item_id"}
            bad += judge_item(got, {k: v[i] for k, v in want[side].items()})
    return bad


def pretrain_inputs(seed: int, n_records: int, batches, traffic) -> Tuple[int, List[Dict]]:
    """(mismatches, reference inputs of each batch) of the staged
    pretraining batches (host tensors), each row matched to its record by
    its first region's class probabilities."""
    shape = (traffic["max_seq_length"], traffic["max_seq_length_pv"], traffic["max_num_pv"])
    draws = {}
    for i in range(n_records):
        d = S.item_draws(seed, i)
        draws[_fp16(d["cls_prob"][0, :8]).tobytes()] = d
    bad, out = 0, []
    for batch in batches:
        b = {k: _np(v) for k, v in batch.items()}
        rows = []
        for r in range(b["input_ids"].shape[0]):
            d = draws.get(_fp16(b["image_target"][r, 0, :8]).tobytes())
            if d is None:
                bad += 1
                continue
            want = item_inputs(d, *shape)
            for ids, labels, key in (("input_ids", "lm_label_ids", "input_ids"),
                                     ("input_ids_pv", "lm_label_ids_pv", "input_ids_pv")):
                masked = b[labels][r] != -1
                bad += int((b[ids][r][~masked] != want[key][~masked]).sum())
                bad += int((b[labels][r][masked] != want[key][masked]).sum())
            for k in ("input_mask", "segment_ids", "input_mask_pv", "segment_ids_pv",
                      "index_p", "index_v", "image_mask"):
                bad += int((b[k][r] != want[k]).sum())
            bad += int((np.abs(b["image_loc"][r] - want["image_loc"]) > 1e-6).sum())
            tgt = want["image_target"]
            bad += int(_near(b["image_target"][r], tgt, _fp16(tgt)).sum())
            # regions: their own features, or zero where the region is a target
            label = b["image_label"][r]
            feat = want["image_feat"].copy()
            staged = b["image_feat"][r]
            zero = np.all(staged[1:] == 0, axis=1)
            own = ~_near(staged[1:], feat[1:], _bf16(feat[1:])).any(axis=1)
            bad += int((~own & ~(zero & (label == 1))).sum())
            feat[1:][zero & (label == 1)] = 0.0
            # the global token: the regions' sum over the regions not
            # co-masked with a target (IoU above 0.4), at least one
            targets = np.where(label == 1)[0]
            co = (iou(d["boxes"])[targets] > 0.4).any(0) if len(targets) else \
                np.zeros(S.N_BOXES, bool)
            feat[0] = feat[1:].sum(0) / max(int((~co).sum()), 1)
            bad += int((np.abs(staged[0] - feat[0]) > 2.0 ** -7 * np.abs(feat[0]) + 1e-5).sum())
            row = dict(want, image_feat=feat)
            for k in ("input_ids", "lm_label_ids", "input_ids_pv", "lm_label_ids_pv",
                      "image_label", "is_next", "is_next_pv_v", "is_next_pv_t"):
                row[k] = b[k][r]
            rows.append(row)
        out.append({k: np.stack([row[k] for row in rows]) for k in rows[0]} if rows else {})
    return bad, out


def to_device(arrays: Dict, device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in arrays.items():
        if isinstance(v, dict):
            out[k] = to_device(v, device)
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(device) if t.is_floating_point() else t.long().to(device)
    return out
