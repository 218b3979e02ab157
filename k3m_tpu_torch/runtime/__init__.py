"""Native host runtime of the port: the C++ K3MR record reader and batch
producer.

The port's copy of k3m_tpu/runtime/__init__.py. `preprocess.cc` (which
includes `recordio.cc` and `arrayrecord.cc`) is compiled at first use by
one `g++` into
`build/k3m_tpu_torch/native/<hash of the sources and flags>/libk3mnative.so`
at the root of the checkout, so a changed source is rebuilt and an
unchanged one reused, and bound with ctypes. Nothing is built when a
module is imported.

  * `NativeRecordReader`: the RecordReader interface over the C++ mmap
    reader;
  * `NativePretrainPreprocessor.batch(indices, seed, epoch)`: record
    indices -> the collated pretraining batch in one C++ call (record
    decode, WordPiece, masking, padding, the global image token), which
    ctypes makes without the interpreter lock. The masking draws come from
    numpy, `default_rng((seed, epoch, i, 0))` per sample, as the Python
    producer draws them (data/preprocess.py `draw_mask_randoms`), and are
    passed in: the C++ draws nothing;
  * `NativePairPreprocessor.batch(indices)`: the same for item-alignment
    pairs (no draws);
  * the `k3mar_*` functions: the Riegeli framing and HighwayHash of
    ArrayRecord files, which k3m_tpu_torch/data/array_record.py calls (it
    raises NativeUnavailable where the library cannot be built).

`get_native_*` return None where the producer is switched off
(K3M_NATIVE_PREPROCESS=0) or cannot be built or opened; a failed build is
logged with the compiler's output. The loaders then run their Python
producer, as the JAX package's do, and say so (`loader.producer`).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

SRC_DIR = Path(__file__).resolve().parent
SOURCES = ("preprocess.cc", "recordio.cc", "arrayrecord.cc")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "k3m_tpu_torch" / "native"
# -ffp-contract=off: no FMA contraction, so the float32 IoU and location
# arithmetic rounds as numpy's does (the batches must be equal bit for bit)
CXX_FLAGS = ["-O3", "-ffp-contract=off", "-pthread", "-shared", "-fPIC"]
LIB_NAME = "libk3mnative.so"

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None      # why the library is unavailable, once known


class NativeUnavailable(RuntimeError):
    """The native library could not be built or loaded."""


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if it is not built yet; return its path. Raises
    NativeUnavailable with the compiler's output if it fails."""
    lib_path = BUILD_ROOT / source_hash() / LIB_NAME
    if lib_path.exists():
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeUnavailable("g++ not found: the native producer needs a C++ compiler")
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp_lib), str(SRC_DIR / "preprocess.cc")]
        run = subprocess.run(cmd, capture_output=True, text=True)
        if run.returncode != 0:
            raise NativeUnavailable(f"native build failed: $ {' '.join(cmd)}\n"
                                    f"{run.stdout}{run.stderr}")
        os.replace(tmp_lib, lib_path)   # atomic: readers never see half a file
    return lib_path


_i32 = ctypes.c_int32
_i64 = ctypes.c_int64
_P = ctypes.c_void_p


def _declare(lib) -> None:
    lib.k3mr_open.restype = _P
    lib.k3mr_open.argtypes = [ctypes.c_char_p]
    lib.k3mr_count.restype = _i64
    lib.k3mr_count.argtypes = [_P]
    lib.k3mr_record.restype = _i64
    lib.k3mr_record.argtypes = [_P, _i64, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.k3mr_close.restype = None
    lib.k3mr_close.argtypes = [_P]
    lib.k3mprep_create.restype = _P
    lib.k3mprep_create.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, _i64,      # record_path, vocab
        _P, _i64,                                    # flags
        _P, _P,                                      # troff, trlen
        _P, _i64,                                    # trpool
        _i32, _i32,                                  # do_lower, char_fallback
        _i32, _i32, _i32, _i32,                      # seq/seq_pv/num_pv/region
        _i32, _i32, _i32, _i32,                      # v_feat, v_target, vt, vis
        _i32, _i32, _i32, _i32, _i32]                # mask/unk/cls/sep/max_chars
    lib.k3mprep_len.restype = _i64
    lib.k3mprep_len.argtypes = [_P]
    lib.k3mprep_encode.restype = _i32
    lib.k3mprep_encode.argtypes = [_P, ctypes.c_char_p, _i64, _P, _i32]
    lib.k3mprep_pretrain_batch.restype = _i32
    lib.k3mprep_pretrain_batch.argtypes = [_P, _P, _i32] + [_P] * 20 + [_i32]
    lib.k3mprep_pair_batch.restype = _i32
    lib.k3mprep_pair_batch.argtypes = [_P, _P, _i32] + [_P] * 27 + [_i32]
    lib.k3mprep_destroy.restype = None
    lib.k3mprep_destroy.argtypes = [_P]
    _u64 = ctypes.c_uint64
    lib.k3mar_hash.restype = _u64
    lib.k3mar_hash.argtypes = [_P, _u64]
    lib.k3mar_chunk_end.restype = _u64
    lib.k3mar_chunk_end.argtypes = [_u64, _u64, _u64]
    lib.k3mar_frame.restype = _i64
    lib.k3mar_frame.argtypes = [_u64, ctypes.c_uint32, _u64, _u64, _P, _u64, _P, _u64]
    lib.k3mar_open.restype = _P
    lib.k3mar_open.argtypes = [ctypes.c_char_p]
    lib.k3mar_size.restype = _u64
    lib.k3mar_size.argtypes = [_P]
    lib.k3mar_chunk_header.restype = _i32
    lib.k3mar_chunk_header.argtypes = [_P, _u64, _P]
    lib.k3mar_chunk_data.restype = _i32
    lib.k3mar_chunk_data.argtypes = [_P, _u64, _u64, _u64, _P]
    lib.k3mar_close.restype = None
    lib.k3mar_close.argtypes = [_P]
    lib.k3mar_varints.restype = _i64
    lib.k3mar_varints.argtypes = [_P, _u64, _P, _u64]
    lib.k3mar_index.restype = _i64
    lib.k3mar_index.argtypes = [_P, _P, _i64, _P, _P]


def library():
    """The loaded native library, built on first use. Raises
    NativeUnavailable (the same error on every later call) if it cannot be
    built or loaded."""
    global _lib, _error
    if _lib is None:
        with _lock:
            if _lib is None and _error is None:
                try:
                    lib = ctypes.CDLL(str(build()))
                    _declare(lib)
                    _lib = lib
                except (NativeUnavailable, OSError) as e:
                    _error = str(e)
                    logger.warning("the native producer is unavailable: %s", _error)
    if _lib is None:
        raise NativeUnavailable(_error)
    return _lib


def native_enabled() -> bool:
    """False where K3M_NATIVE_PREPROCESS=0 switches the native producer off."""
    return os.environ.get("K3M_NATIVE_PREPROCESS", "1") != "0"


class NativeRecordReader:
    """The C++ mmap reader with the RecordReader interface. Opening a file
    that is not K3MR (bad magic, truncated, an index past its end) raises
    ValueError."""

    def __init__(self, path: str):
        self._lib = library()
        self._h = self._lib.k3mr_open(os.fsencode(path))
        if not self._h:
            raise ValueError(f"{path}: not a K3MR file (bad magic, truncated or a bad index)")
        self._n = int(self._lib.k3mr_count(self._h))
        self.path = path

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> Dict[str, Any]:
        from k3m_tpu_torch.data.records import unpack_record
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        length = self._lib.k3mr_record(self._h, int(i), ctypes.byref(ptr))
        if length < 0:
            raise IndexError(f"record {i}: error {length}")
        return unpack_record(ctypes.string_at(ptr, length))

    def __iter__(self):
        for i in range(self._n):
            yield self[i]

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.k3mr_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def get_native_reader(path: str) -> Optional[NativeRecordReader]:
    """A NativeRecordReader, or None where the library is unavailable (a
    file that is not K3MR raises)."""
    try:
        return NativeRecordReader(path)
    except NativeUnavailable:
        return None


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_P)


class NativePretrainPreprocessor:
    """C++ batch producer: record indices -> the collated pretraining batch,
    byte for byte the Python producer's (PretrainPreprocessor +
    collate_pretrain; ref concept_cap_dataset_struc.py:532-933, :381-397)."""

    def __init__(self, record_path: str, tokenizer, shapes, visual_target: int = 0):
        from k3m_tpu_torch.runtime.unicode_tables import get_tables
        lib = library()
        flags, troff, trlen, trpool = (np.ascontiguousarray(a, dt) for a, dt in zip(
            get_tables(), (np.uint8, np.int32, np.uint8, np.uint32)))
        vocab_blob = "\n".join(tokenizer.vocab_list).encode("utf-8")
        s = shapes
        # visual_target != 0 makes the target a copy of the features, so
        # its width is the feature width (data/preprocess.py image_processing)
        t_size = s.v_target_size if visual_target == 0 else s.v_feature_size
        self._h = lib.k3mprep_create(
            os.fsencode(record_path), vocab_blob, len(vocab_blob),
            _ptr(flags), flags.size, _ptr(troff), _ptr(trlen), _ptr(trpool), trpool.size,
            int(tokenizer.do_lower_case), int(tokenizer.char_fallback),
            s.max_seq_len, s.max_seq_len_pv, s.max_num_pv, s.max_region_len,
            s.v_feature_size, t_size, visual_target, 0,      # no visualization masks
            tokenizer.mask_token_id, tokenizer.unk_token_id,
            tokenizer.cls_token_id, tokenizer.sep_token_id, tokenizer.max_chars_per_word)
        if not self._h:
            raise ValueError(f"k3mprep_create failed for {record_path}")
        self._lib = lib
        self._shapes = s
        self._t_size = t_size
        self._vocab_size = len(tokenizer.vocab_list)
        self._n_threads = min(8, os.cpu_count() or 1)

    def __len__(self) -> int:
        return int(self._lib.k3mprep_len(self._h))

    def encode(self, text: str) -> List[int]:
        """Tokenize only (to hold the C++ tokenizer to the Python one)."""
        raw = text.encode("utf-8")
        cap = max(64, 4 * len(raw))
        while True:
            out = np.empty(cap, np.int32)
            n = self._lib.k3mprep_encode(self._h, raw, len(raw), _ptr(out), cap)
            if n >= 0:
                return out[:n].tolist()
            if n <= -1000:
                raise RuntimeError(f"native encode error {n}")
            cap = -n      # the buffer was too small: retry at the size asked

    def batch(self, indices: Sequence[int], seed: int, epoch: int) -> Dict[str, Any]:
        """One collated pretraining batch of the records `indices`."""
        from k3m_tpu_torch.data.preprocess import draw_mask_randoms
        s = self._shapes
        B = len(indices)
        W, R = s.max_seq_len - 2, s.max_region_len
        L, Lpv, NP = s.max_seq_len, s.max_seq_len_pv, s.max_num_pv
        D, T = s.v_feature_size, self._t_size
        idx = np.ascontiguousarray(indices, np.int64)
        probs_w = np.empty((B, W), np.float64)
        rand_w = np.empty((B, W), np.int64)
        probs_r = np.empty((B, R), np.float64)
        for b in range(B):
            probs_w[b], rand_w[b], probs_r[b] = draw_mask_randoms(
                np.random.default_rng((seed, epoch, int(idx[b]), 0)), W,
                self._vocab_size, R)
        o = dict(
            input_ids=np.empty((B, L), np.int32),
            input_mask=np.empty((B, L), np.int32),
            segment_ids=np.empty((B, L), np.int32),
            lm_label_ids=np.empty((B, L), np.int32),
            input_ids_pv=np.empty((B, Lpv), np.int32),
            input_mask_pv=np.empty((B, Lpv), np.int32),
            segment_ids_pv=np.empty((B, Lpv), np.int32),
            lm_label_ids_pv=np.empty((B, Lpv), np.int32),
            index_p=np.empty((B, NP, 2), np.int32),
            index_v=np.empty((B, NP, 2), np.int32),
            image_feat=np.empty((B, R + 1, D), np.float32),
            image_loc=np.empty((B, R + 1, 5), np.float32),
            image_target=np.empty((B, R, T), np.float32),
            image_label=np.empty((B, R), np.int32),
            image_mask=np.empty((B, R + 1), np.int32),
            masked_label=np.empty((B, R), np.float32),
        )
        item_ids = np.zeros((B, 64), np.uint8)
        rc = self._lib.k3mprep_pretrain_batch(
            self._h, _ptr(idx), B, _ptr(probs_w), _ptr(rand_w), _ptr(probs_r),
            *(_ptr(o[k]) for k in (
                "input_ids", "input_mask", "segment_ids", "lm_label_ids", "input_ids_pv",
                "input_mask_pv", "segment_ids_pv", "lm_label_ids_pv", "index_p", "index_v",
                "image_feat", "image_loc", "image_target", "image_label", "image_mask",
                "masked_label")),
            _ptr(item_ids), self._n_threads)
        if rc != 0:
            raise RuntimeError(f"k3mprep_pretrain_batch error {rc}")
        zeros = np.zeros(B, np.int32)
        o["is_next"], o["is_next_pv_v"], o["is_next_pv_t"] = zeros, zeros.copy(), zeros.copy()
        o["item_id"] = _item_ids(item_ids)
        return o

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.k3mprep_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def _item_ids(raw: np.ndarray) -> List[str]:
    return [bytes(row).split(b"\0", 1)[0].decode("utf-8", "replace") for row in raw]


class NativePairPreprocessor(NativePretrainPreprocessor):
    """C++ batch producer for item-alignment pair records: indices -> the
    collated twin-item batch, byte for byte the Python producer's
    (PairPreprocessor + collate_pairs, with the reference's num_boxes
    divide of the global image token). Pairs draw nothing."""

    def _item_arrays(self, B: int) -> Dict[str, Any]:
        s = self._shapes
        L, Lpv, NP = s.max_seq_len, s.max_seq_len_pv, s.max_num_pv
        R, D, T = s.max_region_len, s.v_feature_size, self._t_size
        return dict(
            input_ids=np.empty((B, L), np.int32),
            input_mask=np.empty((B, L), np.int32),
            segment_ids=np.empty((B, L), np.int32),
            input_ids_pv=np.empty((B, Lpv), np.int32),
            input_mask_pv=np.empty((B, Lpv), np.int32),
            segment_ids_pv=np.empty((B, Lpv), np.int32),
            index_p=np.empty((B, NP, 2), np.int32),
            index_v=np.empty((B, NP, 2), np.int32),
            image_feat=np.empty((B, R + 1, D), np.float32),
            image_loc=np.empty((B, R + 1, 5), np.float32),
            image_target=np.empty((B, R, T), np.float32),
            image_mask=np.empty((B, R + 1), np.int32),
        )

    def batch(self, indices: Sequence[int]) -> Dict[str, Any]:
        B = len(indices)
        idx = np.ascontiguousarray(indices, np.int64)
        label = np.empty(B, np.float32)
        items = [self._item_arrays(B) for _ in range(2)]
        raws = [np.zeros((B, 64), np.uint8) for _ in range(2)]
        args = [self._h, _ptr(idx), B, _ptr(label)]
        for o, raw in zip(items, raws):
            args += [_ptr(o[k]) for k in (
                "input_ids", "input_mask", "segment_ids", "input_ids_pv",
                "input_mask_pv", "segment_ids_pv", "index_p", "index_v",
                "image_feat", "image_loc", "image_target", "image_mask")]
            args.append(_ptr(raw))
        args.append(self._n_threads)
        rc = self._lib.k3mprep_pair_batch(*args)
        if rc != 0:
            raise RuntimeError(f"k3mprep_pair_batch error {rc}")
        for o, raw in zip(items, raws):
            o["item_id"] = _item_ids(raw)
        return dict(label=label, item1=items[0], item2=items[1])


def _get(cls, record_path, tokenizer, shapes, **kw):
    if not native_enabled():
        return None
    try:
        return cls(record_path, tokenizer, shapes, **kw)
    except NativeUnavailable:
        return None       # library() logged the compiler's error


def get_native_pretrain_preprocessor(record_path: str, tokenizer, shapes,
                                     **kw) -> Optional[NativePretrainPreprocessor]:
    """The native pretraining producer, or None where it is switched off
    (K3M_NATIVE_PREPROCESS=0) or the library is unavailable."""
    return _get(NativePretrainPreprocessor, record_path, tokenizer, shapes, **kw)


def get_native_pair_preprocessor(record_path: str, tokenizer, shapes,
                                 **kw) -> Optional[NativePairPreprocessor]:
    """The native pair producer, or None as get_native_pretrain_preprocessor."""
    return _get(NativePairPreprocessor, record_path, tokenizer, shapes, **kw)


def unavailable_reason() -> Optional[str]:
    """Why the library could not be built or loaded (None if it was not
    tried or succeeded)."""
    return _error
