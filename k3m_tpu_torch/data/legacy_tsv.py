"""Legacy TSV feature files: writer, reader and record serializer.

Counterpart of k3m_tpu/data/legacy_tsv.py, which follows the reference's
`2_generate_tsv_ali.py` (RoI-feature TSV writer: one row per image,
FIELDNAMES below, boxes/features/cls_prob as base64 float32 buffers written
as the literal string "b'...'", :34,146-157, and read back with `[2:-1]`,
:222-226) and `3_generate_lmdb_ali.py` (joins the TSV with caption/pv/
category from `df_{split}.csv` keyed by image_id, :66-72, and serializes
[features, cls_prob, boxes, num_boxes, image_h, image_w, image_id, caption,
pv, category], :100). The sink is the port's K3MR record writer.

These records keep the reference's legacy layout: they have no `title` and
no `item_id`, so neither the pretraining loader nor ImageFeaturesReader
reads them, in the JAX package as here. The pretraining CLIs train on
`data.prepare`'s records.

`generate_tsv` drives the port's Faster R-CNN (k3m_tpu_torch.vision.frcnn)
over an image list, on the card unless `device="cpu"`.

    python -m k3m_tpu_torch.data.legacy_tsv extract --image_list images/ \\
        --image_dir images/ --output feat.tsv.0 [--weights model.pkl] \\
        [--batch_size 4] [--device cpu]
    python -m k3m_tpu_torch.data.legacy_tsv serialize --tsv feat.tsv.0 \\
        --df_csv df_train.csv --output train_feat.k3mr
"""

from __future__ import annotations

import argparse
import base64
import csv
import json
import logging
import os
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from k3m_tpu_torch.data.records import RecordWriter

logger = logging.getLogger(__name__)

FIELDNAMES = ["image_id", "image_w", "image_h", "num_boxes", "boxes",
              "features", "cls_prob"]


def _b64(arr: np.ndarray) -> str:
    # the reference writes str(bytes): "b'...'" (2_generate_tsv_ali.py:153-156)
    return str(base64.b64encode(np.ascontiguousarray(arr, np.float32).tobytes()))


def _unb64(s: str, dtype=np.float32) -> np.ndarray:
    if s.startswith("b'") and s.endswith("'"):
        s = s[2:-1]
    return np.frombuffer(base64.b64decode(s), dtype=dtype)


def detection_to_row(det: Dict) -> Dict[str, str]:
    """One extractor output (boxes/features/cls_prob arrays) as a TSV row,
    as get_detections_from_image returns it (:146-157)."""
    return {
        "image_id": str(det["image_id"]),
        "image_h": str(int(det["image_h"])),
        "image_w": str(int(det["image_w"])),
        "num_boxes": str(int(det["num_boxes"])),
        "boxes": _b64(np.asarray(det["boxes"])),
        "features": _b64(np.asarray(det["features"])),
        "cls_prob": _b64(np.asarray(det["cls_prob"])),
    }


def write_tsv(rows: Iterable[Dict], outfile: str) -> int:
    n = 0
    with open(outfile, "w", encoding="utf-8", newline="") as f:
        writer = csv.DictWriter(f, delimiter="\t", fieldnames=FIELDNAMES)
        for det in rows:
            writer.writerow(detection_to_row(det))
            n += 1
    return n


def read_tsv(path: str) -> Iterator[Dict]:
    """A feature TSV decoded back to arrays (reference read_tsv :211-233);
    both the "b'...'" framing and plain base64 are read."""
    csv.field_size_limit(500 * 1024 * 1024)
    with open(path, "r", encoding="utf-8") as f:
        reader = csv.DictReader(f, delimiter="\t", fieldnames=FIELDNAMES)
        for row in reader:
            n = int(row["num_boxes"])
            yield {
                "image_id": row["image_id"],
                "image_h": int(row["image_h"]),
                "image_w": int(row["image_w"]),
                "num_boxes": n,
                "boxes": _unb64(row["boxes"]).reshape(n, 4),
                "features": _unb64(row["features"]).reshape(n, 2048),
                "cls_prob": _unb64(row["cls_prob"]).reshape(n, 1601),
            }


def make_extractor(image_dir: str, weights_path: Optional[str] = None, batch_size: int = 4,
                   device="cuda"):
    """The port's detector on `device`: a BatchedExtractor when batch_size
    > 1 (it keeps its count of per-image fallbacks), else an item ->
    detection function."""
    from k3m_tpu_torch.vision import frcnn
    if batch_size > 1:
        return frcnn.make_batched_extractor(weights_path, batch_size=batch_size, device=device)
    return frcnn.make_extractor(image_dir, weights_path, device=device)


def generate_tsv(image_ids: Iterable[Tuple[str, str]], image_dir: str, outfile: str,
                 extractor: Optional[Callable] = None,
                 weights_path: Optional[str] = None, batch_size: int = 4,
                 device="cuda") -> int:
    """Run the RoI extractor over (image_id, image_file) pairs and write the
    TSV (reference generate_tsv :176-208). Without `extractor`, the port's
    detector on `device` (make_extractor; a failed batch goes through the
    per-image path). An image that fails or yields nothing is logged and
    skipped, as the reference's try/except-continue skips it."""
    if extractor is None:
        extractor = make_extractor(image_dir, weights_path, batch_size, device)

    def detections():
        if hasattr(extractor, "map"):
            items = ({"item_image_name": f, "image_id": i} for i, f in image_ids)
            for item, det in extractor.map(items, image_dir=image_dir):
                if det is not None:
                    yield dict(det, image_id=item["image_id"])
            return
        for image_id, image_file in image_ids:
            try:
                det = extractor({"item_image_name": image_file})
            except Exception:
                logger.exception("[ERROR] image_id: %s", image_id)
                continue
            if det is not None:
                yield dict(det, image_id=image_id)

    return write_tsv(detections(), outfile)


def load_caption_index(df_csv: str) -> Dict[str, Tuple[str, str, str]]:
    """image_id -> (pv, caption, category) from a df CSV, with either the
    reference's columns (image_id/caption/pv/category,
    3_generate_lmdb_ali.py:66-72) or data.index's (item_id/title/pv/
    category)."""
    out: Dict[str, Tuple[str, str, str]] = {}
    with open(df_csv, "r", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            key = row.get("image_id") or row.get("item_id") or ""
            caption = row.get("caption") if "caption" in row else row.get("title", "")
            out[str(key)] = (row.get("pv", ""), caption or "", row.get("category", ""))
    return out


def serialize_tsv_to_records(tsv_paths: List[str], df_csv: str, output: str) -> int:
    """3_generate_lmdb_ali's counterpart: TSV rows joined with the df CSV by
    image_id (rows without a match are dropped) -> K3MR records of the
    legacy layout (the TSV row's fields, then caption, pv, category)."""
    index = load_caption_index(df_csv)
    n = 0
    with RecordWriter(output) as w:
        for path in tsv_paths:
            for det in read_tsv(path):
                joined = index.get(str(det["image_id"]))
                if joined is None:
                    continue
                pv, caption, category = joined
                w.write(dict(det, caption=caption, pv=pv, category=category))
                n += 1
    return n


def get_parser():
    ap = argparse.ArgumentParser(prog="python -m k3m_tpu_torch.data.legacy_tsv",
                                 description="Legacy-path feature TSV tools "
                                             "(2_/3_ equivalents)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("extract", help="images -> feature TSV")
    g.add_argument("--image_list", required=True,
                   help="json of [[image_id, image_file], ...] or a directory")
    g.add_argument("--image_dir", required=True)
    g.add_argument("--weights", default=None)
    g.add_argument("--output", required=True)
    g.add_argument("--batch_size", type=int, default=4,
                   help="images per device call (1 = per-image path)")
    g.add_argument("--device", default="cuda",
                   help="device of the extractor (default cuda; cpu runs it on the CPU)")
    s = sub.add_parser("serialize", help="TSV + df csv -> K3MR records")
    s.add_argument("--tsv", nargs="+", required=True)
    s.add_argument("--df_csv", required=True)
    s.add_argument("--output", required=True)
    return ap


def main(argv=None) -> Dict:
    """Runs the CLI; returns {"rows" or "records": n, "output": path, and
    for extract "extractor": the extractor (a BatchedExtractor keeps its
    fallback count and flush times)}."""
    args = get_parser().parse_args(argv)
    if args.cmd == "extract":
        if os.path.isdir(args.image_list):
            pairs = [(os.path.splitext(p)[0], p) for p in sorted(os.listdir(args.image_list))]
        else:
            with open(args.image_list, "r", encoding="utf-8") as f:
                pairs = [tuple(x) for x in json.load(f)]
        extractor = make_extractor(args.image_dir, args.weights, args.batch_size, args.device)
        n = generate_tsv(pairs, args.image_dir, args.output, extractor=extractor)
        print(f"wrote {n} rows -> {args.output}")
        return dict(rows=n, output=args.output, extractor=extractor)
    n = serialize_tsv_to_records(args.tsv, args.df_csv, args.output)
    print(f"wrote {n} records -> {args.output}")
    return dict(records=n, output=args.output)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
