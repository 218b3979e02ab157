"""Record loading: K3MR record file -> fixed-shape numpy batches.

The port's own copy of k3m_tpu/data/pipeline.py (reference
ConceptCapLoaderTrain_struc and K3MDataLoader, concept_cap_dataset_struc.py:
179-529) on one host, with the pure-Python producer: one background thread
reads, preprocesses and collates batches ahead of the consumer. Epoch e
visits the records in the permutation drawn from (seed, e, 1) and sample i
is preprocessed with the Generator of (seed, e, i, 0), as the JAX
package's loaders do (pipeline.py:121-136), so the two yield equal batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from k3m_tpu_torch.data.preprocess import (
    PairPreprocessor, PretrainPreprocessor, ShapeSpec, add_global_image_token,
)
from k3m_tpu_torch.data.records import RecordReader
from k3m_tpu_torch.tokenization import WordPieceTokenizer


def _stack(samples, key):
    # preallocate and assign rows: np.stack of many separately allocated
    # [36, 2048] arrays is several times slower
    first = np.asarray(samples[0][key])
    out = np.empty((len(samples),) + first.shape, first.dtype)
    for j, s in enumerate(samples):
        out[j] = s[key]
    return out


def _collate_alignment_item(items) -> Dict[str, np.ndarray]:
    d = {k: _stack(items, k) for k in items[0] if k != "item_id"}
    d["item_id"] = [s["item_id"] for s in items]
    # the global image token divides by num_boxes (ref post_process :272-294)
    divisor = d.pop("num_boxes")[:, None].astype(np.float32)
    d["image_feat"], d["image_loc"], d["image_mask"] = add_global_image_token(
        d["image_feat"], d["image_loc"], d["image_mask"], divisor)
    return d


def collate_pairs(samples) -> Dict:
    """Pair-batch collate (K3MDataLoader semantics)."""
    return dict(
        label=np.stack([s["label"] for s in samples]).astype(np.float32),
        item1=_collate_alignment_item([s["item1"] for s in samples]),
        item2=_collate_alignment_item([s["item2"] for s in samples]),
    )


def collate_pretrain(samples) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into a pretrain batch and prepend the global
    image token, dividing by the count of regions not co-masked, at least
    1 (ref :381-397)."""
    batch = {k: _stack(samples, k) for k in samples[0] if k != "item_id"}
    batch["item_id"] = [s["item_id"] for s in samples]
    count = (batch["masked_label"] == 0).sum(axis=1, keepdims=True)
    count[count == 0] = 1
    batch["image_feat"], batch["image_loc"], batch["image_mask"] = add_global_image_token(
        batch["image_feat"], batch["image_loc"], batch["image_mask"], count)
    return batch


class _LoaderBase:
    """A seeded, threaded batch producer over one record file; subclasses
    give `_map(i)` (one sample) and `_collate(samples)`."""

    def __init__(self, record_path: str, batch_size: int, shuffle: bool,
                 seed: int, drop_last: bool, prefetch: int):
        self.reader = RecordReader(record_path)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.reader)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.reader))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch, 1)).shuffle(idx)
        return idx

    def _sample_rng(self, i: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self.epoch, i, 0))

    def _produce(self, out_q: "queue.Queue", stop: threading.Event):
        try:
            batch = []
            for i in self._indices():
                if stop.is_set():
                    return
                batch.append(self._map(int(i)))
                if len(batch) == self.batch_size:
                    out_q.put(self._collate(batch))
                    batch = []
            if batch and not self.drop_last:
                out_q.put(self._collate(batch))
        except Exception as e:      # handed to the consumer, raised there
            out_q.put(e)
        finally:
            out_q.put(None)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(q, stop), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # a consumer that stops early must not leave the producer
            # blocked on a full queue
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()
        self.epoch += 1


class AlignmentLoader(_LoaderBase):
    """Item-alignment pair loader matching K3MDataLoader (ref :179-294)."""

    def __init__(self, record_path: str, tokenizer: WordPieceTokenizer,
                 shapes: Optional[ShapeSpec] = None, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 0, visual_target: int = 0,
                 drop_last: bool = True, prefetch: int = 4):
        super().__init__(record_path, batch_size, shuffle, seed, drop_last, prefetch)
        self.preprocessor = PairPreprocessor(tokenizer, shapes or ShapeSpec(),
                                             visual_target=visual_target)

    def _map(self, i: int):
        return self.preprocessor(self.reader[i])

    def _collate(self, samples):
        return collate_pairs(samples)


class PretrainLoader(_LoaderBase):
    """Pretraining loader matching ConceptCapLoaderTrain_struc/Val_struc
    (ref :297-529), with MLM and RoI masking drawn per sample."""

    def __init__(self, record_path: str, tokenizer: WordPieceTokenizer,
                 shapes: Optional[ShapeSpec] = None, batch_size: int = 32,
                 shuffle: bool = True, seed: int = 0, visual_target: int = 0,
                 drop_last: bool = True, prefetch: int = 4):
        super().__init__(record_path, batch_size, shuffle, seed, drop_last, prefetch)
        self.preprocessor = PretrainPreprocessor(tokenizer, shapes or ShapeSpec(),
                                                 visual_target=visual_target)

    def _map(self, i: int):
        return self.preprocessor(self.reader[i], self._sample_rng(i))

    def _collate(self, samples):
        return collate_pretrain(samples)
