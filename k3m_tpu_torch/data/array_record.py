"""ArrayRecord files: the port's own reader and writer.

The counterpart of `write_array_records` and `ArrayRecordStore` of
k3m_tpu/data/grain_pipeline.py:42-77, which go through the `array_record`
and `grain` packages. The port depends on neither: it reads and writes the
file format itself, so that each side reads the other's files.

An ArrayRecord file is a Riegeli records file (64 KiB blocks with a
24-byte block header each, 40-byte chunk headers, HighwayHash-64 of every
header and of every chunk's data):
  * the file signature chunk ('s') at 0;
  * one simple chunk ('r') a record (array_record's `group_size:1`): a
    compression byte ('z' zstd, 0 none), a varint length, the compressed
    varint record sizes, the compressed values; each compressed buffer is
    a varint of its decoded size and one zstd frame (level 3, window log
    20);
  * the footer, a simple chunk whose first record is the file's metadata
    (version, chunk and record counts, the writer's options string) and
    then one index record per chunk (its offset, decoded size and record
    count);
  * padding ('p') to the next block boundary, the postscript (an
    uncompressed simple chunk of three copies of {footer offset, magic})
    at the start of the last block, and padding to the end of the file.
The payloads are the port's msgpack records (records.py `pack_record`),
as in the JAX package. The framing and hashes run in C++ (the port's
native library, k3m_tpu_torch/runtime/arrayrecord.cc); zstd through
ctypes on the system's `libzstd.so.1`. Without either, opening or writing
a file raises by name (`NativeUnavailable`, `ZstdUnavailable`); a file
whose hashes or layout do not hold raises `ArrayRecordError`.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading
from typing import Any, Dict, Iterable, Iterator, List, Tuple

import numpy as np

from k3m_tpu_torch.data.records import pack_record, unpack_record

BLOCK = 1 << 16
BLOCK_HEADER = 24
CHUNK_HEADER = 40
OPTIONS = ("group_size:1,transpose:false,pad_to_block_boundary:false,zstd:3,"
           "window_log:20,max_parallelism:1")
ZSTD_LEVEL, ZSTD_WINDOW_LOG = 3, 20
POSTSCRIPT_MAGIC = 0x71930E704FDAE05E
POSTSCRIPT_COPIES = 3
VERSION = 1
SIGNATURE, SIMPLE, PADDING, TRANSPOSED = ord("s"), ord("r"), ord("p"), ord("t")
_ZSTD_C_COMPRESSION_LEVEL, _ZSTD_C_WINDOW_LOG = 100, 101   # zstd.h ZSTD_cParameter


class ArrayRecordError(ValueError):
    """A file that is not a well-formed ArrayRecord file: a hash that does
    not match, a truncated file, or a chunk this reader does not read."""


class ZstdUnavailable(RuntimeError):
    """The system's zstd library (libzstd.so.1) cannot be loaded."""


_zstd_lock = threading.Lock()
_zstd = None


def zstd():
    """The system's libzstd through ctypes; raises ZstdUnavailable if the
    host has none."""
    global _zstd
    with _zstd_lock:
        if _zstd is None:
            lib = None
            for name in ("libzstd.so.1", ctypes.util.find_library("zstd")):
                try:
                    lib = ctypes.CDLL(name) if name else None
                except OSError:
                    continue
                if lib is not None:
                    break
            if lib is None:
                raise ZstdUnavailable(
                    "libzstd.so.1 is not found: ArrayRecord chunks are zstd-compressed and "
                    "the port reads and writes them through the system's zstd library")
            size_t, P = ctypes.c_size_t, ctypes.c_void_p
            for fn, res, args in (
                    ("ZSTD_compressBound", size_t, [size_t]),
                    ("ZSTD_createCCtx", P, []),
                    ("ZSTD_freeCCtx", size_t, [P]),
                    ("ZSTD_CCtx_setParameter", size_t, [P, ctypes.c_int, ctypes.c_int]),
                    ("ZSTD_compress2", size_t, [P, P, size_t, P, size_t]),
                    ("ZSTD_decompress", size_t, [P, size_t, P, size_t]),
                    ("ZSTD_isError", ctypes.c_uint, [size_t]),
                    ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
                    ("ZSTD_versionNumber", ctypes.c_uint, [])):
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = args
            _zstd = lib
    return _zstd


def _zstd_check(rc: int, what: str) -> int:
    z = zstd()
    if z.ZSTD_isError(rc):
        raise ArrayRecordError(f"{what}: zstd: {z.ZSTD_getErrorName(rc).decode()}")
    return rc


def _native():
    from k3m_tpu_torch.runtime import library
    return library()


def _ptr(a) -> ctypes.c_void_p:
    return ctypes.c_void_p(np.frombuffer(a, np.uint8).ctypes.data if len(a) else 0)


# ------------------------------------------------------------- varints

def varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def read_varint(buf, pos: int) -> Tuple[int, int]:
    """(value, next position) of the varint at `pos`."""
    value = shift = 0
    while True:
        if pos >= len(buf) or shift > 63:
            raise ArrayRecordError("a varint runs past its buffer")
        c = int(buf[pos])
        pos += 1
        value |= (c & 0x7F) << shift
        shift += 7
        if c < 0x80:
            return value, pos


def _proto(fields: Iterable[Tuple[int, Any]]) -> bytes:
    """A protobuf message of varint (int) and length-delimited (bytes)
    fields, in the order given."""
    out = bytearray()
    for num, v in fields:
        if isinstance(v, bytes):
            out += varint(num << 3 | 2) + varint(len(v)) + v
        else:
            out += varint(num << 3) + varint(v)
    return bytes(out)


def _proto_fields(buf) -> Dict[int, Any]:
    """The varint and length-delimited fields of a protobuf message (the
    last of a repeated number)."""
    out, pos = {}, 0
    while pos < len(buf):
        tag, pos = read_varint(buf, pos)
        if tag & 7 == 0:
            out[tag >> 3], pos = read_varint(buf, pos)
        elif tag & 7 == 2:
            n, pos = read_varint(buf, pos)
            if pos + n > len(buf):
                raise ArrayRecordError("a protobuf field runs past its message")
            out[tag >> 3], pos = bytes(buf[pos:pos + n]), pos + n
        else:
            raise ArrayRecordError(f"protobuf wire type {tag & 7} is not read here")
    return out


# --------------------------------------------------------------- writer

class ArrayRecordWriter:
    """Writes an ArrayRecord file of one record a chunk, as array_record's
    `ArrayRecordWriter(path, "group_size:1")` does. `write(record)` packs a
    record dict; `write_payload(bytes)` writes bytes as they are."""

    def __init__(self, path: str):
        self._lib = _native()
        z = zstd()
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._cctx = z.ZSTD_createCCtx()
        for param, value in ((_ZSTD_C_COMPRESSION_LEVEL, ZSTD_LEVEL),
                             (_ZSTD_C_WINDOW_LOG, ZSTD_WINDOW_LOG)):
            _zstd_check(z.ZSTD_CCtx_setParameter(self._cctx, param, value), "set parameter")
        self._f = open(path, "wb")
        self._pos = 0
        self._index: List[bytes] = []
        self._chunk(SIGNATURE, 0, 0, b"")

    def _compress(self, data: bytes) -> bytes:
        z = zstd()
        cap = z.ZSTD_compressBound(len(data))
        out = np.empty(cap, np.uint8)
        n = _zstd_check(z.ZSTD_compress2(self._cctx, _ptr(out), cap, _ptr(data), len(data)),
                        self.path)
        return varint(len(data)) + out[:n].tobytes()

    def _simple_chunk(self, records: List[bytes], compress: bool = True) -> bytes:
        sizes = b"".join(varint(len(r)) for r in records)
        values = b"".join(records)
        if compress:
            sizes, values = self._compress(sizes), self._compress(values)
        return bytes([ord("z") if compress else 0]) + varint(len(sizes)) + sizes + values

    def _chunk(self, kind: int, num_records: int, decoded: int, data: bytes) -> int:
        """Frames and appends one chunk; returns its offset."""
        begin = self._pos
        end = self._lib.k3mar_chunk_end(begin, len(data), num_records)
        out = np.empty(end - begin, np.uint8)
        n = self._lib.k3mar_frame(begin, kind, num_records, decoded, _ptr(data), len(data),
                                  _ptr(out), out.size)
        if n != out.size:
            raise RuntimeError(f"{self.path}: framing a chunk at {begin} failed ({n})")
        self._f.write(out.data)
        self._pos = end
        return begin

    def _pad(self) -> None:
        """A padding chunk up to the next block boundary (over one more
        block where no chunk header fits before it)."""
        left = -self._pos % BLOCK
        if left == 0:
            return
        if left < CHUNK_HEADER:
            left += BLOCK - BLOCK_HEADER
        self._chunk(PADDING, 0, 0, bytes(left - CHUNK_HEADER))

    def write_payload(self, payload: bytes) -> None:
        offset = self._chunk(SIMPLE, 1, len(payload), self._simple_chunk([payload]))
        self._index.append(_proto([(1, offset), (2, len(payload)), (3, 1)]))

    def write(self, record: Dict[str, Any]) -> None:
        self.write_payload(pack_record(record))

    def close(self) -> None:
        if self._f is None:
            return
        try:
            meta = _proto([(1, _proto([(1, VERSION), (2, len(self._index)),
                                       (3, len(self._index)), (4, OPTIONS.encode())]))])
            footer = [meta] + self._index
            footer_offset = self._chunk(SIMPLE, len(footer), sum(map(len, footer)),
                                        self._simple_chunk(footer))
            self._pad()
            post = [_proto([(1, footer_offset), (2, POSTSCRIPT_MAGIC)])] * POSTSCRIPT_COPIES
            self._chunk(SIMPLE, len(post), sum(map(len, post)),
                        self._simple_chunk(post, compress=False))
            self._pad()
        finally:
            self._f.close()
            self._f = None
            zstd().ZSTD_freeCCtx(self._cctx)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_array_records(path: str, records) -> int:
    """ArrayRecord counterpart of records.write_records (the same
    payloads); returns the count written."""
    n = 0
    with ArrayRecordWriter(path) as w:
        for rec in records:
            w.write(rec)
            n += 1
    return n


# --------------------------------------------------------------- reader

_HEADER_ERRORS = {-1: "truncated, or a block header that does not match",
                  -2: "the chunk header's hash does not match"}
_DATA_ERRORS = {-1: "truncated, or a block header that does not match",
                -3: "the chunk data's hash does not match"}


class ArrayRecordStore:
    """Random-access reader of an ArrayRecord file of msgpack records, with
    the interface of records.RecordReader (`__len__`, `__getitem__`,
    `__iter__`, `close`; `payload(i)` gives the record's bytes). Record i is
    found from the footer's chunk offsets; every chunk it reads is checked
    against its hashes. Reads zstd and uncompressed simple chunks of any
    group size; thread-safe."""

    def __init__(self, path: str):
        self.path = path
        self._lib = _native()
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{path}: no such ArrayRecord file")
        self._h = self._lib.k3mar_open(os.fsencode(path))
        if not self._h:
            raise ArrayRecordError(f"{path}: cannot be read, or too short for an "
                                   "ArrayRecord file")
        try:
            self._read_footer()
        except BaseException:
            self.close()
            raise

    def _chunk(self, begin: int) -> Tuple[int, int, int, np.ndarray]:
        """(type, record count, decoded size, data) of the chunk at
        `begin`, its hashes checked."""
        head = np.zeros(5, np.uint64)
        rc = self._lib.k3mar_chunk_header(self._h, begin, head.ctypes.data_as(ctypes.c_void_p))
        if rc:
            raise ArrayRecordError(f"{self.path}: chunk at {begin}: {_HEADER_ERRORS[rc]}")
        size, kind, count, decoded, end = (int(x) for x in head)
        if end > self._size:
            raise ArrayRecordError(f"{self.path}: chunk at {begin} ends at {end}, past the "
                                   f"end of the file ({self._size} bytes)")
        data = np.empty(size, np.uint8)
        rc = self._lib.k3mar_chunk_data(self._h, begin, end, size, _ptr(data))
        if rc:
            raise ArrayRecordError(f"{self.path}: chunk at {begin}: {_DATA_ERRORS[rc]}")
        return kind, count, decoded, data

    def _decode(self, buf: np.ndarray, compression: int, begin: int) -> np.ndarray:
        if compression == 0:
            return buf
        if compression != ord("z"):
            raise ArrayRecordError(
                f"{self.path}: chunk at {begin}: compression {chr(compression)!r} is not "
                "read here (zstd 'z' and uncompressed only)")
        n, pos = read_varint(buf, 0)
        out = np.empty(n, np.uint8)
        src = buf[pos:]
        got = _zstd_check(zstd().ZSTD_decompress(_ptr(out), n, _ptr(src), src.size),
                          f"{self.path}: chunk at {begin}")
        if got != n:
            raise ArrayRecordError(f"{self.path}: chunk at {begin}: {got} bytes decoded, "
                                   f"{n} expected")
        return out

    def _records(self, begin: int) -> Tuple[np.ndarray, np.ndarray]:
        """(record sizes, values) of the simple chunk at `begin`."""
        kind, count, decoded, data = self._chunk(begin)
        if kind != SIMPLE:
            raise ArrayRecordError(
                f"{self.path}: chunk at {begin} is of type {chr(kind)!r}, not a simple chunk "
                "of records ('r')" + ("; transposed chunks are not read here"
                                      if kind == TRANSPOSED else ""))
        if data.size == 0:
            raise ArrayRecordError(f"{self.path}: chunk at {begin} has no data")
        n_sizes, pos = read_varint(data, 1)
        raw = self._decode(data[pos:pos + n_sizes], int(data[0]), begin)
        values = self._decode(data[pos + n_sizes:], int(data[0]), begin)
        sizes = np.empty(count, np.uint64)
        got = self._lib.k3mar_varints(_ptr(raw), raw.size, sizes.ctypes.data_as(
            ctypes.c_void_p), count)
        if got != count or int(sizes.sum()) != values.size or values.size != decoded:
            raise ArrayRecordError(f"{self.path}: chunk at {begin}: its record sizes do not "
                                   f"match its header ({got} of {count} records)")
        return sizes, values

    def _read_footer(self) -> None:
        self._size = int(self._lib.k3mar_size(self._h))
        try:
            signed = self._chunk(0)[0] == SIGNATURE
        except ArrayRecordError:
            signed = False
        if not signed:
            raise ArrayRecordError(f"{self.path}: not an ArrayRecord file (no Riegeli "
                                   "file signature)")
        post_at = (self._size - 1) // BLOCK * BLOCK
        sizes, values = self._records(post_at)
        post = _proto_fields(values[:int(sizes[0])])
        if post.get(2) != POSTSCRIPT_MAGIC or 1 not in post:
            raise ArrayRecordError(f"{self.path}: no ArrayRecord postscript at {post_at}")
        sizes, values = self._records(post[1])
        meta = _proto_fields(_proto_fields(values[:int(sizes[0])]).get(1, b""))
        n_chunks, n_records = meta.get(2), meta.get(3)
        if n_chunks is None or n_records is None or n_chunks != sizes.size - 1:
            raise ArrayRecordError(f"{self.path}: the footer's metadata does not match its "
                                   f"{sizes.size - 1} index records")
        self.writer_options = meta.get(4, b"").decode()
        offsets = np.empty(n_chunks, np.uint64)
        counts = np.empty(n_chunks, np.uint64)
        rc = self._lib.k3mar_index(_ptr(values[int(sizes[0]):]), sizes[1:].ctypes.data_as(
            ctypes.c_void_p), n_chunks, offsets.ctypes.data_as(ctypes.c_void_p),
            counts.ctypes.data_as(ctypes.c_void_p))
        if rc:
            raise ArrayRecordError(f"{self.path}: index record {-rc - 1} is malformed")
        if int(counts.sum()) != n_records:
            raise ArrayRecordError(f"{self.path}: the index counts {int(counts.sum())} "
                                   f"records, the metadata {n_records}")
        self._offsets = offsets.astype(np.int64)
        self._first = np.concatenate([[0], np.cumsum(counts.astype(np.int64))])
        self._one_a_chunk = bool((counts == 1).all())
        self._n = n_records

    def __len__(self) -> int:
        return self._n

    def payload(self, i: int) -> bytes:
        """Record i's bytes."""
        i = int(i)
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(f"record {i} of {self._n}")
        chunk = i if self._one_a_chunk else int(np.searchsorted(self._first, i, "right")) - 1
        sizes, values = self._records(int(self._offsets[chunk]))
        j = i - int(self._first[chunk])
        start = int(sizes[:j].sum())
        return values[start:start + int(sizes[j])].tobytes()

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return unpack_record(self.payload(i))

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for i in range(self._n):
            yield self[i]

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.k3mar_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def is_array_record(path: str) -> bool:
    """Whether `path` names an ArrayRecord file (by its extension, as the
    JAX package decides)."""
    return str(path).endswith(".array_record")
