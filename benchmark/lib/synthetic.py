"""Synthetic K3M records from a seed, at the shapes the port's loaders
run at full width: a title of 48 CJK characters (50 tokens with [CLS] and
[SEP]), a pv string of 30 `key:value;` pairs (truncated to 256 tokens),
36 RoIs of a 480 x 640 image with 2,048 features and 1,601 class
probabilities each. Every item is drawn from its own generator, keyed by
(seed, item index), so that any item can be drawn again alone: the
reference recomputes the items the program was fed from the seed.

Rewritten from the port's smoke script (`_synthetic_item`,
`write_pretrain_records`, `write_pair_records`); the records are written
with the program's own record writer, the format its loaders read.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

N_BOXES = 36
IMAGE_H, IMAGE_W = 480, 640
FEATURES, CLASSES = 2048, 1601
TITLE_CHARS = 48
PV_PAIRS = 30
KEY_CHARS, VALUE_CHARS = 3, 4

# the synthetic vocab's layout (bert-base-chinese's special tokens): ids
# 0 [PAD], 100 [UNK], 101 [CLS], 102 [SEP], 103 [MASK], 106-199 the
# printable ASCII ('!' .. '~'), then the CJK ideographs from U+4E00
CLS_ID, SEP_ID, MASK_ID = 101, 102, 103
COLON_ID, SEMI_ID = 131, 132
CJK_FIRST_ID = 200
CJK_COUNT = 20928          # ids 200 .. 21127 of a 21,128-word vocab


def _cjk(ids: np.ndarray) -> str:
    return "".join(chr(0x4E00 + int(j)) for j in ids)


def item_draws(seed: int, index: int) -> Dict[str, np.ndarray]:
    """The raw draws of item `index`: character indices (into the CJK
    ideographs) of the title and of each pv key and value, the boxes,
    features and class probabilities."""
    rng = np.random.default_rng([int(seed), int(index)])
    title = rng.integers(0, CJK_COUNT, TITLE_CHARS)
    keys = rng.integers(0, CJK_COUNT, (PV_PAIRS, KEY_CHARS))
    values = rng.integers(0, CJK_COUNT, (PV_PAIRS, VALUE_CHARS))
    x0 = rng.uniform(0, IMAGE_W / 2, N_BOXES)
    y0 = rng.uniform(0, IMAGE_H / 2, N_BOXES)
    boxes = np.stack([x0, y0, x0 + rng.uniform(8, IMAGE_W / 2, N_BOXES),
                      y0 + rng.uniform(8, IMAGE_H / 2, N_BOXES)], 1).astype(np.float32)
    features = rng.random((N_BOXES, FEATURES), dtype=np.float32)
    cls = rng.random((N_BOXES, CLASSES), dtype=np.float32)
    return dict(title=title, keys=keys, values=values, boxes=boxes, features=features,
                cls_prob=cls / cls.sum(1, keepdims=True))


def item_record(seed: int, index: int) -> Dict:
    d = item_draws(seed, index)
    pv = "".join(_cjk(k) + ":" + _cjk(v) + ";" for k, v in zip(d["keys"], d["values"]))
    return dict(item_id=f"item{index}", title=_cjk(d["title"]), pv=pv, category="c",
                image_h=IMAGE_H, image_w=IMAGE_W, num_boxes=N_BOXES, boxes=d["boxes"],
                features=d["features"], cls_prob=d["cls_prob"])


def write_pretrain_records(path: str, seed: int, n: int) -> int:
    """`n` pretraining records, item i drawn from (seed, i)."""
    from k3m_tpu_torch.data.records import write_records
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return write_records(path, (item_record(seed, i) for i in range(n)))


def pair_label(seed: int, i: int) -> float:
    return float(np.random.default_rng([int(seed), int(i), 1]).integers(0, 2))


def write_pair_records(path: str, seed: int, n: int) -> int:
    """`n` pair records: pair i holds items 2i and 2i + 1 and a label
    drawn from (seed, i, 1)."""
    from k3m_tpu_torch.data.records import write_records
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pairs = (dict(label=pair_label(seed, i), item1=item_record(seed, 2 * i),
                  item2=item_record(seed, 2 * i + 1)) for i in range(n))
    return write_records(path, pairs)


# ------------------------------------------------- the items' model inputs

def title_ids(d) -> List[int]:
    return [CLS_ID] + [CJK_FIRST_ID + int(j) for j in d["title"]] + [SEP_ID]


def pv_ids(d, max_len: int) -> List[int]:
    ids: List[int] = []
    for k, v in zip(d["keys"], d["values"]):
        ids += [CJK_FIRST_ID + int(j) for j in k] + [COLON_ID]
        ids += [CJK_FIRST_ID + int(j) for j in v] + [SEMI_ID]
    return [CLS_ID] + ids[:max_len - 2] + [SEP_ID]


def pv_spans(ids: List[int], max_num_pv: int):
    """(index_p, index_v) [max_num_pv, 2]: each pair's key span [begin,
    position of ':'] and value span [':' + 1, position of ';'] where both
    marks are present; a pair cut by the truncation has none; zero rows
    after the last."""
    colons = [i for i, t in enumerate(ids) if t == COLON_ID]
    semis = [i for i, t in enumerate(ids) if t == SEMI_ID]
    index_p, index_v, begin = [], [], 1
    for a, b in zip(colons, semis):
        index_p.append([begin, a])
        index_v.append([a + 1, b])
        begin = b + 1
        if len(index_p) >= max_num_pv:
            break
    pad = [[0, 0]] * (max_num_pv - len(index_p))
    return (np.array(index_p + pad, np.int64), np.array(index_v + pad, np.int64))


def image_loc(d) -> np.ndarray:
    b = d["boxes"].astype(np.float32)
    loc = np.zeros((N_BOXES, 5), np.float32)
    loc[:, :4] = b
    loc[:, 4] = (b[:, 3] - b[:, 1]) * (b[:, 2] - b[:, 0]) / (float(IMAGE_W) * float(IMAGE_H))
    loc[:, 0] /= IMAGE_W
    loc[:, 1] /= IMAGE_H
    loc[:, 2] /= IMAGE_W
    loc[:, 3] /= IMAGE_H
    return loc
