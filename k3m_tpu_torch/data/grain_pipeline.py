"""The grain backend of the port: ArrayRecord files, grain's sampler order,
per-record preprocessing in worker processes, batches made in the parent.

The counterpart of k3m_tpu/data/grain_pipeline.py (`GrainPretrainLoader`,
`GrainAlignmentLoader`), without the `grain` package (which imports JAX)
and without `array_record`:
  * the record order is grain's `IndexSampler(num_records,
    ShardOptions(shard_index, shard_count, drop_remainder=True),
    shuffle, num_epochs=1, seed)` read at the indices k * shard_count +
    shard_index, as grain's DataLoader reads it: the shard is a contiguous
    piece of the keys (`even_split`), shuffled by grain's Feistel
    `index_shuffle` (grain/_src/python/dataset/transformations/
    shuffle.py:62-71 and its C++ library), which `index_shuffle` here
    computes bit for bit;
  * each epoch's shuffle seed is `_epoch_seed(seed, epoch)` and sample
    `key` is preprocessed with `default_rng((seed, epoch, key, 0))`, the
    stream of the port's `PretrainLoader` (pipeline.py `_sample_rng`), so
    a batch does not depend on the worker count;
  * `num_workers` > 0 maps the records in `torch.utils.data.DataLoader`
    worker processes (spawned, kept for the loader's life), one sample at
    a time and in order (`batch_size=None`); the parent makes the batches
    (`_batched`), as the JAX loaders do;
  * the native hybrid: where a `.k3mr` sibling holds the same records in
    the same order (`_siblings_match`), the sampler's keys go to the
    port's C++ batch producer instead (runtime/preprocess.cc), byte for
    byte the per-record path's batches.
The shard is the caller's: `run_pretraining` passes the data rank and the
data-parallel size (never the model rank), so the model ranks of a data
group read one batch. `__len__` counts the shard's batches.

Two facts of the JAX loaders that the port does not copy: their native
hybrid reads `sampler[i]` for i = 0, 1, ... (grain_pipeline.py:126-137),
which under more than one process yields each key `shard_count` times in
a row (the port gives the DataLoader path's sequence); and their
`__len__` counts the whole file whatever the process count (:252-255).
On one process the two packages agree.
"""

from __future__ import annotations

import math
import os
import weakref
from typing import Callable, Iterable, Optional

import numpy as np

from k3m_tpu_torch.data.array_record import ArrayRecordStore
from k3m_tpu_torch.data.pipeline import collate_pairs, collate_pretrain
from k3m_tpu_torch.data.preprocess import PairPreprocessor, PretrainPreprocessor, ShapeSpec
from k3m_tpu_torch.runtime import (
    get_native_pair_preprocessor, get_native_pretrain_preprocessor, native_enabled,
    unavailable_reason,
)
from k3m_tpu_torch.tokenization import WordPieceTokenizer

_M32 = 0xFFFFFFFF


# ----------------------------------------------------------- the sampler

def _seed_seq(seed: int, n: int):
    """`std::seed_seq{seed}.generate(n)` (C++11 [rand.util.seedseq]), the
    Feistel round keys of grain's index_shuffle."""
    v, s = [seed & _M32], 1
    b = [0x8B8B8B8B] * n
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p = (n - t) // 2
    q = p + t
    m = max(s + 1, n)

    def T(x):
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * T(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n])) & _M32
        r2 = (r1 + (s if k == 0 else (k % n + v[k - 1] if k <= s else k % n))) & _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * T((b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _M32)) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def _feistel(max_index: int, seed: int, rounds: int):
    """(half width, mask, round keys) of grain's index_shuffle: a balanced
    Feistel network over the smallest even bit width w (at least 16) of
    max_index, as grain's C++ computes it (ceil of a double log2)."""
    if rounds % 2:
        raise ValueError(f"rounds must be even, not {rounds}")
    w = math.ceil(math.log2(float(max_index)))
    w = max(w + w % 2, 16)
    mask = (1 << (w // 2)) - 1
    return w // 2, mask, [k & mask for k in _seed_seq(seed, rounds)]


def _walk(i: int, max_index: int, half: int, mask: int, keys) -> int:
    """The network applied to `i` until the value lies in [0, max_index]."""
    def f(v):
        def rotl(r):
            return ((v << r) | (v >> (half - r))) & mask
        return (rotl(1) & rotl(8)) ^ rotl(2)

    while True:
        x, y = (i >> half) & mask, i & mask       # an index past 2**w keeps w bits
        for j in range(0, len(keys), 2):
            x ^= f(y) ^ keys[j]
            y ^= f(x) ^ keys[j + 1]
        i = (x << half) | y
        if i <= max_index:
            return i


def _index_shuffle_array(index: np.ndarray, max_index: int, seed: int,
                         rounds: int = 4) -> np.ndarray:
    """grain's index_shuffle of every element of `index`, each at most
    max_index: numpy passes over the array while many elements still walk,
    then the few left one by one (a walk into a small max_index takes up
    to thousands of passes)."""
    if max_index == 0:
        return np.zeros(index.shape, np.uint64)
    half, mask, keys = _feistel(max_index, seed, rounds)
    h, m = np.uint64(half), np.uint64(mask)
    ks = [np.uint64(k) for k in keys]

    def f(v):
        def rotl(r):
            return ((v << np.uint64(r)) | (v >> (h - np.uint64(r)))) & m
        return (rotl(1) & rotl(8)) ^ rotl(2)

    out = index.astype(np.uint64, copy=True)
    todo = np.arange(out.size)
    while todo.size > 256:
        i = out[todo]
        x, y = (i >> h) & m, i & m
        for j in range(0, rounds, 2):
            x = x ^ f(y) ^ ks[j]
            y = y ^ f(x) ^ ks[j + 1]
        out[todo] = (x << h) | y
        todo = todo[out[todo] > np.uint64(max_index)]
    for t in todo:
        out[t] = _walk(int(out[t]), max_index, half, mask, keys)
    return out


def index_shuffle(index: int, max_index: int, seed: int, rounds: int = 4) -> int:
    """grain's `index_shuffle(index, max_index, seed, rounds)`: the position
    of `index` in a seeded pseudo-random order of [0, max_index]."""
    if max_index == 0:
        return 0
    return _walk(int(index), max_index, *_feistel(max_index, seed, rounds))


def sampled_keys(num_records: int, shuffle: bool, seed: int, shard_index: int = 0,
                 shard_count: int = 1) -> np.ndarray:
    """The record keys grain's `IndexSampler(num_records, ShardOptions(
    shard_index, shard_count, drop_remainder=True), shuffle, num_epochs=1,
    seed)` gives at the indices k * shard_count + shard_index, k = 0, 1, ...
    (grain's DataLoader order): the shard's contiguous piece of the keys,
    shuffled within it."""
    if num_records <= 0:
        raise ValueError(f"num_records must be positive, not {num_records}")
    if not 0 <= shard_index < shard_count:
        raise ValueError(f"shard_index {shard_index} not in [0, {shard_count})")
    per_shard = num_records // shard_count
    keys = np.arange(per_shard, dtype=np.uint64)
    if shuffle and per_shard:
        if not 0 <= seed < 2 ** 32:
            raise ValueError(f"the shuffle seed must be a 32-bit integer, not {seed}")
        keys = _index_shuffle_array(keys, per_shard - 1, seed)
    return (keys.astype(np.int64) + per_shard * shard_index)


def _epoch_seed(seed: int, epoch: int) -> int:
    """Deterministic per-epoch shuffle seed (k3m_tpu/data/grain_pipeline.py:195-197)."""
    return int(np.random.default_rng((seed, epoch, 1)).integers(2 ** 31 - 1))


def _batched(sample_iter: Iterable, batch_size: int, drop_last: bool, collate: Callable):
    batch = []
    for s in sample_iter:
        batch.append(s)
        if len(batch) == batch_size:
            yield collate(batch)
            batch = []
    if batch and not drop_last:
        yield collate(batch)


# ------------------------------------------------------- the record map

class _RecordMap:
    """Item (epoch, key): record `key` of the file, preprocessed (with the
    record's own Generator (seed, epoch, key, 0) where `draws`). Opens its
    own store in the process that first reads it, so that worker processes
    do not share the parent's."""

    def __init__(self, path: str, preprocessor, seed: int, draws: bool):
        self.path, self.pre, self.seed, self.draws = path, preprocessor, seed, draws
        self._store = None
        self._pid = None

    def __getitem__(self, item):
        epoch, key = item
        if self._pid != os.getpid():
            self._store, self._pid = ArrayRecordStore(self.path), os.getpid()
        rec = self._store[key]
        if self.draws:
            return self.pre(rec, np.random.default_rng((self.seed, epoch, key, 0)))
        return self.pre(rec)

    def __getstate__(self):
        return dict(self.__dict__, _store=None, _pid=None)


class _EpochKeys:
    """The worker path's sampler: (epoch, key) of every key of the epoch the
    loader is in when an iteration starts. Holds the loader weakly, so that
    dropping the loader ends its workers."""

    def __init__(self, loader: "_GrainLoader"):
        self._loader = weakref.ref(loader)

    def __iter__(self):
        loader = self._loader()
        epoch = loader.epoch
        return ((epoch, int(k)) for k in loader._keys(epoch))


def _identity(sample):
    return sample


def _native_sibling(path: str, explicit: Optional[str]) -> Optional[str]:
    if explicit is not None:
        return explicit if os.path.exists(explicit) else None
    if path.endswith(".array_record"):
        sib = path[: -len(".array_record")] + ".k3mr"
        return sib if os.path.exists(sib) else None
    return None


def _siblings_match(store: ArrayRecordStore, k3mr_path: str, n: int) -> bool:
    """Cheap same-content guard of the hybrid (k3m_tpu/data/
    grain_pipeline.py:146-165): the K3MR sibling must hold as many records
    with the same first and last item_id (the native producer reads by
    index)."""
    from k3m_tpu_torch.data.records import RecordReader
    try:
        rd = RecordReader(k3mr_path)
        try:
            if len(rd) != n:
                return False
            return all(str(rd[i].get("item_id")) == str(store[i].get("item_id"))
                       for i in (0, n - 1))
        finally:
            rd.close()
    except Exception:
        return False


class _GrainLoader:
    """What both grain loaders share: the file, the shard, the epoch
    counter, the per-record path (in this process, or in `num_workers`
    spawned worker processes that live as long as the loader) and the
    native hybrid."""

    def __init__(self, path: str, tokenizer: WordPieceTokenizer, preprocessor, draws: bool,
                 batch_size: int, shuffle: bool, seed: int, num_workers: int, drop_last: bool,
                 native_preprocess: bool, native_sibling: Optional[str], make_native,
                 shard_index: int, shard_count: int):
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index {shard_index} not in [0, {shard_count})")
        self._map = _RecordMap(path, preprocessor, seed, draws)
        store = ArrayRecordStore(path)
        self.num_dataset = len(store)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._shuffle = shuffle
        self._seed = seed
        self._workers = num_workers
        self._dataloader = None
        self.shard_index, self.shard_count = shard_index, shard_count
        self.epoch = 0      # bumped per full iteration, like _LoaderBase
        self._native = None
        self.native_error: Optional[str] = None
        if not native_preprocess:
            self.native_error = "native_preprocess=False"
        elif not native_enabled():
            self.native_error = "K3M_NATIVE_PREPROCESS=0"
        elif hasattr(tokenizer, "vocab_list"):
            sib = _native_sibling(path, native_sibling)
            if sib is None:
                self.native_error = "no .k3mr sibling"
            elif not _siblings_match(store, sib, self.num_dataset):
                self.native_error = f"{sib} does not hold the same records"
            else:
                nat = make_native(sib)
                if nat is not None and len(nat) == self.num_dataset:
                    self._native = nat
                else:
                    self.native_error = unavailable_reason() or f"{sib}: not read"
        store.close()

    @property
    def producer(self) -> str:
        """"native" (the hybrid) or "python" (the per-record map)."""
        return "python" if self._native is None else "native"

    def __len__(self) -> int:
        n = self.num_dataset // self.shard_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _keys(self, epoch: int) -> np.ndarray:
        seed = _epoch_seed(self._seed, epoch) if self._shuffle else self._seed
        return sampled_keys(self.num_dataset, self._shuffle, seed, self.shard_index,
                            self.shard_count)

    def _samples(self, epoch: int):
        """The epoch's samples in the sampler's order: mapped in this
        process, or by the worker processes (started at the first epoch,
        one sample an item, returned in order)."""
        if self._workers == 0:
            return (self._map[(epoch, int(k))] for k in self._keys(epoch))
        if self._dataloader is None:
            from torch.utils.data import DataLoader
            self._dataloader = DataLoader(
                self._map, batch_size=None, sampler=_EpochKeys(self),
                num_workers=self._workers, collate_fn=_identity,
                multiprocessing_context="spawn", persistent_workers=True)
        return iter(self._dataloader)

    def _iterate(self, native_batch, collate):
        epoch = self.epoch
        if self._native is not None:
            yield from _batched(self._keys(epoch), self.batch_size, self.drop_last,
                                lambda keys: native_batch(keys, epoch))
        else:
            yield from _batched(self._samples(epoch), self.batch_size, self.drop_last,
                                collate)
        self.epoch += 1

    def close(self) -> None:
        """Ends the worker processes (dropping the loader does too)."""
        self._dataloader = None


class GrainPretrainLoader(_GrainLoader):
    """Grain-backed pretraining loader; the batches of PretrainLoader's dict
    (k3m_tpu/data/grain_pipeline.py:211-276). `num_epochs` is accepted, as
    the JAX loader accepts it; the trainer sets `.epoch`."""

    def __init__(self, path: str, tokenizer: WordPieceTokenizer,
                 shapes: Optional[ShapeSpec] = None, batch_size: int = 32,
                 shuffle: bool = True, seed: int = 0, visual_target: int = 0,
                 num_epochs: Optional[int] = None, num_workers: int = 0,
                 drop_last: bool = True, native_preprocess: bool = True,
                 native_sibling: Optional[str] = None, shard_index: int = 0,
                 shard_count: int = 1):
        shapes = shapes or ShapeSpec()
        super().__init__(
            path, tokenizer, PretrainPreprocessor(tokenizer, shapes, visual_target=visual_target),
            True, batch_size, shuffle, seed, num_workers, drop_last, native_preprocess,
            native_sibling, lambda sib: get_native_pretrain_preprocessor(
                sib, tokenizer, shapes, visual_target=visual_target),
            shard_index, shard_count)

    def __iter__(self):
        return self._iterate(lambda keys, epoch: self._native.batch(keys, self._seed, epoch),
                             collate_pretrain)


class GrainAlignmentLoader(_GrainLoader):
    """Grain-backed item-alignment pair loader; AlignmentLoader's batches
    (k3m_tpu/data/grain_pipeline.py:279-333). Pairs draw nothing."""

    def __init__(self, path: str, tokenizer: WordPieceTokenizer,
                 shapes: Optional[ShapeSpec] = None, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 0, visual_target: int = 0,
                 num_epochs: Optional[int] = None, num_workers: int = 0,
                 drop_last: bool = True, native_preprocess: bool = True,
                 native_sibling: Optional[str] = None, shard_index: int = 0,
                 shard_count: int = 1):
        shapes = shapes or ShapeSpec()
        super().__init__(
            path, tokenizer, PairPreprocessor(tokenizer, shapes, visual_target=visual_target),
            False, batch_size, shuffle, seed, num_workers, drop_last, native_preprocess,
            native_sibling, lambda sib: get_native_pair_preprocessor(
                sib, tokenizer, shapes, visual_target=visual_target),
            shard_index, shard_count)

    def __iter__(self):
        return self._iterate(lambda keys, epoch: self._native.batch(keys), collate_pairs)
