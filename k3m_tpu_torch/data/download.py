"""Raw-data cleaning and product-image download.

Counterpart of k3m_tpu/data/download.py, the reference's
`0_deal_raw_data_segment.py` (clean_and_down_pic :8, rename_pic :40): splits
the raw TSV, strips the '#' pv separators, names the images
`{count}_s{segment}`, and (optionally, off by default) downloads them with
per-item error tolerance. Offline, or without `requests`, the download step
degrades: items keep their records, images are absent, and the zero-box
feature fallback applies downstream.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)


def clean_and_download(raw_data_path: str, segment_id: int, output_dir: str,
                       image_dir: Optional[str] = None,
                       download: bool = False, timeout: float = 10.0) -> int:
    os.makedirs(output_dir, exist_ok=True)
    if image_dir:
        os.makedirs(image_dir, exist_ok=True)
    out_file = os.path.join(output_dir, f"id_title_pvs_cls.txt{segment_id}")
    session = None
    if download:
        try:
            import requests
            session = requests.Session()
        except ImportError:
            logger.warning("requests unavailable; skipping image download")
    count = 0
    with open(raw_data_path, "r", encoding="utf-8", errors="ignore") as fin, \
            open(out_file, "w", encoding="utf-8") as fout:
        for line in fin:
            parts = line.strip().split("\t")
            if len(parts) != 5:
                logger.warning("skipping malformed line: %.60s", line)
                continue
            item_id, title, image_url, pv_str, category = parts
            pv_str = pv_str.replace("#", "")
            pic_type = image_url.split(".")[-1]
            pic_name = f"{count}_s{segment_id}.{pic_type}"
            if session is not None and image_dir:
                try:
                    resp = session.get(image_url, timeout=timeout)
                    if resp.status_code == 200:
                        with open(os.path.join(image_dir, pic_name), "wb") as fp:
                            fp.write(resp.content)
                except Exception as e:   # per-item tolerance (ref :27-31)
                    logger.warning("download failed for %s: %s", image_url, e)
            fout.write("\t".join([f"{count}_s{segment_id}", title, pic_name,
                                  pv_str, category, item_id]) + "\n")
            count += 1
    return count


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", required=True)
    ap.add_argument("--segment_id", type=int, default=0)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--image_dir", default=None)
    ap.add_argument("--download", action="store_true")
    args = ap.parse_args(argv)
    n = clean_and_download(args.input, args.segment_id, args.output_dir,
                           args.image_dir, args.download)
    print(f"cleaned {n} items")
    return n


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
