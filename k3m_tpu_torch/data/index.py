"""Dataset indexing: per-field JSONs and a dataframe CSV.

Counterpart of k3m_tpu/data/index.py, the reference's
`1_generate_json_ali.py` (load_image_ids :50, generate_df :73,
generate_json :101): from cleaned TSV rows, writes
  df_{split}.csv                    (item rows)
  {field}_{split}.json              (field -> list, aligned by row) for
                                    caption/pic/pv/itemID/category
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Iterator

FIELD_MAP = dict(caption="title", pic="image_url", pv="pv", itemID="item_id",
                 category="category")


def build_index(rows: Iterator[Dict], output_dir: str, split: str) -> Dict[str, int]:
    os.makedirs(output_dir, exist_ok=True)
    rows = list(rows)
    with open(os.path.join(output_dir, f"df_{split}.csv"), "w", newline="",
              encoding="utf-8") as f:
        writer = csv.DictWriter(
            f, fieldnames=["item_id", "title", "image_url", "pv", "category"])
        writer.writeheader()
        for r in rows:
            writer.writerow({k: r.get(k, "") for k in writer.fieldnames})
    for out_field, src_field in FIELD_MAP.items():
        with open(os.path.join(output_dir, f"{out_field}_{split}.json"), "w",
                  encoding="utf-8") as f:
            json.dump([r.get(src_field, "") for r in rows], f, ensure_ascii=False)
    return {"rows": len(rows)}


def main(argv=None):
    import argparse

    from k3m_tpu_torch.data.prepare import parse_raw_tsv

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--split", default="train")
    args = ap.parse_args(argv)
    stats = build_index(parse_raw_tsv(args.input), args.output_dir, args.split)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
