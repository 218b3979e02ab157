"""Random-access RoI feature reader keyed by item/image id.

Counterpart of k3m_tpu/data/feature_reader.py, the API of the reference
`ImageFeaturesH5Reader` (vilbert_k3m/datasets/_image_features_reader.py:
17-181). Reads a K3MR feature record file, or an HDF5 file laid out as the
reference docstring's schema (`image_id` (N,), `features` (N, P, 2048),
:23-29), and returns (features, num_boxes, locations) with the global token
(the mean of the boxes' features) prepended and the 5-d normalized location
layout [x1/w, y1/h, x2/w, y2/h, box area / image area].

Records are looked up by `item_id`, so `data.prepare`'s records are read;
the legacy TSV serializer's records (image_id, no item_id) are not, as in
the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from k3m_tpu_torch.data.records import RecordReader


class _H5Records:
    """An HDF5 feature file through RecordReader's dict-per-record
    interface. Datasets: `image_id` (N,), `features` (N, P, F); optional
    `boxes` (N, P, 4), `num_boxes` (N,), `image_h`/`image_w` (N,). Missing
    boxes give zero locations, like the reference's zero-box fallback."""

    def __init__(self, path: str):
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"reading {path} needs h5py, which is not installed; "
                              f"convert the file to K3MR records") from e
        self.f = h5py.File(path, "r")
        self.n = len(self.f["image_id"])

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict:
        f = self.f
        feats = np.asarray(f["features"][i], np.float32)
        num = int(f["num_boxes"][i]) if "num_boxes" in f else feats.shape[0]
        boxes = (np.asarray(f["boxes"][i], np.float32) if "boxes" in f
                 else np.zeros((feats.shape[0], 4), np.float32))
        iid = f["image_id"][i]
        if isinstance(iid, bytes):
            iid = iid.decode("utf-8")
        return dict(item_id=iid, features=feats, boxes=boxes, num_boxes=num,
                    image_h=int(f["image_h"][i]) if "image_h" in f else 1,
                    image_w=int(f["image_w"][i]) if "image_w" in f else 1)


class ImageFeaturesReader:
    def __init__(self, record_path: str, in_memory: bool = False):
        if record_path.endswith((".h5", ".hdf5")):
            self.reader = _H5Records(record_path)
        else:
            self.reader = RecordReader(record_path)
        self._by_id = {str(self.reader[i]["item_id"]): i for i in range(len(self.reader))}
        self._cache: Optional[Dict[str, Tuple]] = {} if in_memory else None
        self.keys = list(self._by_id)

    def __len__(self) -> int:
        return len(self.reader)

    def __contains__(self, image_id) -> bool:
        return str(image_id) in self._by_id

    def __getitem__(self, image_id) -> Tuple[np.ndarray, int, np.ndarray]:
        key = str(image_id)
        if self._cache is not None and key in self._cache:
            return self._cache[key]
        rec = self.reader[self._by_id[key]]
        num_boxes = int(rec["num_boxes"])
        features = np.asarray(rec["features"], np.float32)
        boxes = np.asarray(rec["boxes"], np.float32)
        h, w = float(rec["image_h"] or 1), float(rec["image_w"] or 1)
        loc = np.zeros((num_boxes, 5), np.float32)
        if num_boxes:
            loc[:, :4] = boxes[:num_boxes]
            loc[:, 4] = (loc[:, 3] - loc[:, 1]) * (loc[:, 2] - loc[:, 0]) / (w * h)
            loc[:, 0] /= w
            loc[:, 1] /= h
            loc[:, 2] /= w
            loc[:, 3] /= h
        # the global token: the boxes' mean feature and the whole image
        if num_boxes:
            g_feat = features[:num_boxes].mean(0, keepdims=True)
        else:
            g_feat = np.zeros((1, features.shape[1] if features.size else 2048), np.float32)
        g_loc = np.array([[0, 0, 1, 1, 1]], np.float32)
        features = np.concatenate([g_feat, features[:num_boxes]], axis=0)
        loc = np.concatenate([g_loc, loc], axis=0)
        out = (features, num_boxes + 1, loc)
        if self._cache is not None:
            self._cache[key] = out
        return out
