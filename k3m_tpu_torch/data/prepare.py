"""Offline data preparation: raw TSV or item_info jsonl -> record files,
with the RoI features of the port's Faster R-CNN on the card.

Counterpart of k3m_tpu/data/prepare.py, which replaces the reference chain
`0_deal_raw_data_segment.py` -> `1_generate_json_ali.py` ->
`2_generate_tsv_ali.py` -> `3_generate_lmdb_ali.py` and the unified
`data_prepare.py` with one CLI producing K3MR record files, or ArrayRecord
files where `--output` ends in `.array_record` (data/array_record.py; a
`--features` file is read by its extension too), as the JAX CLI does.

Raw TSV line format (reference data/README.md and
0_deal_raw_data_segment.py:17-18):
    itemID \\t title \\t image_url \\t pv_string \\t category
'#' chars are stripped from the pv string and a trailing ';' appended
(data_prepare.py:335-336); optional jieba word segmentation
(data_prepare.py:337-338).

With --extract_features, `k3m_tpu_torch.vision.frcnn` extracts each image's
RoI features on the card (`--device`, default cuda); otherwise, or for an
image that yields nothing, the zero-box placeholder of the reference
(data_prepare.py:342-345) is stored.

Usage:
    python -m k3m_tpu_torch.data.prepare --item_info info.jsonl \\
        --image_dir images/ --extract_features --extract_batch_size 4 \\
        [--frcnn_weights faster_rcnn_from_caffe.pkl] --output out/train_feat.k3mr
    python -m k3m_tpu_torch.data.prepare --pairs pairs.jsonl \\
        --features out/train_feat.k3mr --output out/train_pairs.k3mr
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from k3m_tpu_torch.data.array_record import ArrayRecordStore, ArrayRecordWriter, is_array_record
from k3m_tpu_torch.data.records import RecordReader, RecordWriter

logger = logging.getLogger(__name__)

def parse_raw_tsv(path: str, segment_jieba: bool = False) -> Iterator[Dict]:
    if segment_jieba:
        import jieba
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) != 5:
                continue
            item_id, title, image_url, pv_str, category = parts
            pv_str = pv_str.replace("#", "")
            if not pv_str.endswith(";"):
                pv_str += ";"
            if segment_jieba:
                pv_str = " ".join(jieba.cut(pv_str))
                title = " ".join(jieba.cut(title))
            yield dict(item_id=item_id, title=title, image_url=image_url,
                       pv=pv_str, category=category)


def parse_item_info_jsonl(path: str, segment_jieba: bool = True) -> Iterator[Dict]:
    """New-pipeline jsonl input (reference data_prepare.py:310-345):
    {item_id, item_image_name, title, item_pvs, cate_name}; '#' stripped,
    trailing ';' appended, optional jieba segmentation."""
    if segment_jieba:
        import jieba
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            jd = json.loads(line.strip())
            pv = jd.get("item_pvs", "").replace("#", "")
            if not pv.endswith(";"):
                pv += ";"
            title = jd.get("title", "")
            if segment_jieba:
                pv = " ".join(jieba.cut(pv))
                title = " ".join(jieba.cut(title))
            yield dict(item_id=str(jd["item_id"]), title=title, pv=pv,
                       category=jd.get("cate_name", ""),
                       item_image_name=jd.get("item_image_name", ""))


def _feature_record(item: Dict, det: Optional[Dict]) -> Dict:
    """One output record from (raw item, detection-or-None): the record
    schema for both the per-image and the batched path (the zero-box
    placeholder where there is no detection, ref data_prepare.py:360-366)."""
    rec = dict(item_id=item["item_id"], title=item["title"],
               pv=item["pv"], category=item["category"],
               image_h=0, image_w=0, num_boxes=0,
               boxes=np.zeros((0, 4), np.float32),
               features=np.zeros((0, 2048), np.float32),
               cls_prob=np.zeros((0, 1601), np.float32))
    if det is not None:
        rec.update(image_h=int(det["image_h"]),
                   image_w=int(det["image_w"]),
                   num_boxes=int(det["num_boxes"]),
                   boxes=np.asarray(det["boxes"], np.float32),
                   features=np.asarray(det["features"], np.float32),
                   cls_prob=np.asarray(det["cls_prob"], np.float32))
    return rec


def build_feature_records(
        raw: Iterator[Dict],
        extractor: Optional[Callable[[Dict], Optional[Dict]]] = None,
        image_dir: Optional[str] = None) -> Iterator[Dict]:
    """Attach RoI features (or the zero-box placeholder) to each raw item."""
    for item in raw:
        det = (extractor(item)
               if extractor is not None and image_dir is not None else None)
        yield _feature_record(item, det)


def build_feature_records_batched(raw: Iterator[Dict], batch_extractor,
                                  image_dir: Optional[str]) -> Iterator[Dict]:
    """build_feature_records through a BatchedExtractor: one device call per
    batch of images instead of per image."""
    for item, det in batch_extractor.map(raw, image_dir=image_dir):
        yield _feature_record(item, det)


def build_pair_records(pairs_jsonl: str, feature_record_path: str) -> Iterator[Dict]:
    """Join item-alignment pairs against a feature record file (reference
    pair_serialize, data_prepare.py:519-545)."""
    reader = (ArrayRecordStore(feature_record_path) if is_array_record(feature_record_path)
              else RecordReader(feature_record_path))
    by_id = {}
    for i in range(len(reader)):
        by_id[str(reader[i]["item_id"])] = i
    with open(pairs_jsonl, "r", encoding="utf-8") as f:
        for line in f:
            jd = json.loads(line)
            id1, id2 = str(jd["src_item_id"]), str(jd["tgt_item_id"])
            if id1 not in by_id or id2 not in by_id:
                continue
            yield dict(label=float(jd.get("item_label", jd.get("label", 0))),
                       item1=reader[by_id[id1]], item2=reader[by_id[id2]])


def get_parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", help="raw TSV file")
    ap.add_argument("--item_info", help="item_info jsonl (new pipeline)")
    ap.add_argument("--pairs", help="item-alignment pairs jsonl")
    ap.add_argument("--features", help="feature record file to join pairs against")
    ap.add_argument("--output", required=True)
    ap.add_argument("--image_dir", default=None)
    ap.add_argument("--jieba", action="store_true")
    ap.add_argument("--extract_features", action="store_true",
                    help="run the Faster R-CNN RoI extractor")
    ap.add_argument("--extract_batch_size", type=int, default=4,
                    help="images per device call (1 = per-image path)")
    ap.add_argument("--frcnn_weights", default=None,
                    help="bottom-up-attention caffe pkl for the extractor")
    ap.add_argument("--device", default="cuda",
                    help="device of the extractor (default cuda; cpu runs it on the CPU)")
    return ap


def main(argv=None) -> Dict:
    """Runs the CLI; returns {"records": n, "output": path, "extractor":
    the extractor or None} (a BatchedExtractor keeps its flush times and
    fallback count)."""
    args = get_parser().parse_args(argv)

    extractor = None
    if args.extract_features:
        from k3m_tpu_torch.vision import frcnn
        if args.extract_batch_size > 1:
            extractor = frcnn.make_batched_extractor(
                args.frcnn_weights, batch_size=args.extract_batch_size,
                device=args.device)
        else:
            extractor = frcnn.make_extractor(args.image_dir, args.frcnn_weights,
                                             device=args.device)

    if args.pairs:
        records = build_pair_records(args.pairs, args.features)
    else:
        if args.item_info:
            raw = parse_item_info_jsonl(args.item_info, segment_jieba=args.jieba)
        else:
            raw = parse_raw_tsv(args.input, segment_jieba=args.jieba)
        if extractor is not None and hasattr(extractor, "map"):
            records = build_feature_records_batched(raw, extractor, args.image_dir)
        else:
            records = build_feature_records(raw, extractor, args.image_dir)

    n = 0
    with (ArrayRecordWriter if is_array_record(args.output) else RecordWriter)(args.output) as w:
        for rec in records:
            w.write(rec)
            n += 1
    print(f"wrote {n} records to {args.output}")
    return dict(records=n, output=args.output, extractor=extractor)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
