"""Record loading: K3MR or ArrayRecord file -> fixed-shape numpy batches.

The port's own copy of k3m_tpu/data/pipeline.py (reference
ConceptCapLoaderTrain_struc and K3MDataLoader, concept_cap_dataset_struc.py:
179-529) on one host. One background thread produces batches ahead of the
consumer, with one of two producers (`loader.producer`):
  * "native": the C++ producer of k3m_tpu_torch/runtime (record decode,
    tokenization, masking and collate of a whole batch in one call made
    without the interpreter lock), the default, as in the JAX package;
  * "python": read, preprocess and collate sample by sample in Python,
    where `native_preprocess=False`, K3M_NATIVE_PREPROCESS=0, or the native
    library cannot be built (logged with the compiler's error;
    `native_error` says why), and for an `.array_record` file, which is
    read through data/array_record.py `ArrayRecordStore` as the JAX
    loaders read it.
Epoch e visits the records in the permutation drawn from (seed, e, 1) and
sample i is preprocessed with the Generator of (seed, e, i, 0), as the JAX
package's loaders do (pipeline.py:121-136), so all of them yield equal
batches. Under data parallelism each rank reads one shard (`num_shards`,
`shard_index`, JAX pipeline.py:107-131): every shard draws the same
permutation, takes the stride slice idx[shard::num_shards] and truncates it
to num_dataset // num_shards, so that every rank runs the same number of
steps; a sample's masking depends on its record index alone, so a rank's
batch does not depend on the shard count.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from k3m_tpu_torch.data.array_record import ArrayRecordStore, is_array_record
from k3m_tpu_torch.data.preprocess import (
    PairPreprocessor, PretrainPreprocessor, ShapeSpec, add_global_image_token,
)
from k3m_tpu_torch.data.records import RecordReader
from k3m_tpu_torch.runtime import (
    get_native_pair_preprocessor, get_native_pretrain_preprocessor, get_native_reader,
    native_enabled, unavailable_reason,
)
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
    give `_map(i)` (one sample), `_collate(samples)` and, for the native
    producer, `_native_batch(indices)`."""

    def __init__(self, record_path: str, batch_size: int, shuffle: bool,
                 seed: int, drop_last: bool, prefetch: int, num_shards: int = 1,
                 shard_index: int = 0):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        if is_array_record(record_path):
            # as the JAX loaders read them (k3m_tpu/data/pipeline.py:91-93)
            self.reader = ArrayRecordStore(record_path)
        else:
            self.reader = get_native_reader(record_path) or RecordReader(record_path)
        self.record_path = record_path
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        self.native = None
        self.native_error: Optional[str] = None

    def _attach_native(self, make, native_preprocess: bool) -> None:
        """The native producer `make()` gives, where it is wanted; else the
        reason the Python producer runs (`native_error`)."""
        if not native_preprocess:
            self.native_error = "native_preprocess=False"
        elif is_array_record(self.record_path):
            self.native_error = "an ArrayRecord file: the native producer reads K3MR files"
        elif not native_enabled():
            self.native_error = "K3M_NATIVE_PREPROCESS=0"
        else:
            self.native = make()
            if self.native is None:
                self.native_error = unavailable_reason()

    @property
    def producer(self) -> str:
        """"native" or "python": which producer makes the batches."""
        return "python" if self.native is None else "native"

    def __len__(self) -> int:
        n = len(self.reader) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        n = len(self.reader)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch, 1)).shuffle(idx)
        if self.num_shards > 1:
            idx = idx[self.shard_index::self.num_shards][:n // self.num_shards]
        return idx

    def _sample_rng(self, i: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self.epoch, i, 0))

    def _batch(self, indices: np.ndarray):
        if self.native is not None:
            return self._native_batch(indices)
        return self._collate([self._map(int(i)) for i in indices])

    def _produce(self, out_q: "queue.Queue", stop: threading.Event):
        try:
            idx = self._indices()
            B = self.batch_size
            full = len(idx) - len(idx) % B
            chunks = [idx[k:k + B] for k in range(0, full, B)]
            if full < len(idx) and not self.drop_last:
                chunks.append(idx[full:])
            for chunk in chunks:
                if stop.is_set():
                    return
                out_q.put(self._batch(chunk))
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
                 drop_last: bool = True, prefetch: int = 4, native_preprocess: bool = True,
                 num_shards: int = 1, shard_index: int = 0):
        super().__init__(record_path, batch_size, shuffle, seed, drop_last, prefetch,
                         num_shards, shard_index)
        shapes = shapes or ShapeSpec()
        self.preprocessor = PairPreprocessor(tokenizer, shapes, visual_target=visual_target)
        self._attach_native(lambda: get_native_pair_preprocessor(
            record_path, tokenizer, shapes, visual_target=visual_target), native_preprocess)

    def _map(self, i: int):
        return self.preprocessor(self.reader[i])

    def _collate(self, samples):
        return collate_pairs(samples)

    def _native_batch(self, indices):
        return self.native.batch(indices)


class PretrainLoader(_LoaderBase):
    """Pretraining loader matching ConceptCapLoaderTrain_struc/Val_struc
    (ref :297-529), with MLM and RoI masking drawn per sample."""

    def __init__(self, record_path: str, tokenizer: WordPieceTokenizer,
                 shapes: Optional[ShapeSpec] = None, batch_size: int = 32,
                 shuffle: bool = True, seed: int = 0, visual_target: int = 0,
                 drop_last: bool = True, prefetch: int = 4, native_preprocess: bool = True,
                 num_shards: int = 1, shard_index: int = 0):
        super().__init__(record_path, batch_size, shuffle, seed, drop_last, prefetch,
                         num_shards, shard_index)
        shapes = shapes or ShapeSpec()
        self.preprocessor = PretrainPreprocessor(tokenizer, shapes,
                                                 visual_target=visual_target)
        self._attach_native(lambda: get_native_pretrain_preprocessor(
            record_path, tokenizer, shapes, visual_target=visual_target), native_preprocess)

    def _map(self, i: int):
        return self.preprocessor(self.reader[i], self._sample_rng(i))

    def _collate(self, samples):
        return collate_pretrain(samples)

    def _native_batch(self, indices):
        return self.native.batch(indices, self.seed, self.epoch)
