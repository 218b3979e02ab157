"""K3MR record files: the port's reader and writer.

The same single-file format as k3m_tpu/data/records.py, so either package
reads the other's files:

    [magic "K3MR"][u32 version]
    [u64 len][payload] * N
    [u64 offset] * N            <- trailer index
    [u64 N][u64 index_offset][magic "K3MX"]

Payloads are msgpack maps; a numpy array is the map
{"__nd__": 1, "d": dtype-str, "s": shape, "b": raw-bytes}. The port carries
its own codec for the msgpack subset the records use (map, str, bin, int,
float, array, nil, bool), and encodes each value in the smallest form, as
msgpack-python's packer with `use_bin_type=True` does, so a file it writes
is byte-for-byte the file the JAX package writes for the same records.
Decoded arrays are zero-copy views into the reader's mmap.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Any, Dict, Iterator, List

import numpy as np

MAGIC = b"K3MR"
TRAILER_MAGIC = b"K3MX"
VERSION = 1


# ----------------------------------------------------------------- encode

def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for tag, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < limit:
                out.append(tag)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"integer {n} does not fit msgpack")
    else:
        for tag, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if n >= -limit:
                out.append(tag)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, out: bytearray, fix_base, fix_max, tags) -> None:
    """Length header: a fix form below `fix_max`, else the first of
    (tag8, tag16, tag32) that holds n (tag8 may be None)."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
        return
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < limit:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = memoryview(obj).cast("B")
        _pack_len(len(b), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, (None, 0xDC, 0xDD))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack({"__nd__": 1, "d": obj.dtype.str, "s": list(obj.shape),
               "b": obj.tobytes()}, out)
    elif isinstance(obj, np.integer):
        _pack_int(int(obj), out)
    elif isinstance(obj, np.floating):
        _pack(float(obj), out)
    else:
        raise TypeError(f"cannot serialize {type(obj)}")


def pack_record(record: Dict[str, Any]) -> bytes:
    out = bytearray()
    _pack(record, out)
    return bytes(out)


# ----------------------------------------------------------------- decode

_FIXED = {  # tag -> (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {  # tag -> (kind, header format, header size)
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


def _as_array(d: Dict) -> np.ndarray:
    return np.frombuffer(d["b"], dtype=np.dtype(d["d"])).reshape(d["s"])


def _owned(x):
    """A `bin` value outside an ndarray map as `bytes`, like msgpack."""
    return bytes(x) if isinstance(x, memoryview) else x


def _unpack(buf: memoryview, pos: int):
    """Decode one value at `pos`; returns (value, next position). `bin`
    values are memoryview slices of `buf` (no copy)."""
    tag = buf[pos]
    pos += 1
    if tag < 0x80:
        return tag, pos
    if tag >= 0xE0:
        return tag - 0x100, pos
    if 0xA0 <= tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif 0x90 <= tag <= 0x9F:
        kind, n = "array", tag & 0x0F
    elif 0x80 <= tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif tag == 0xC0:
        return None, pos
    elif tag == 0xC2:
        return False, pos
    elif tag == 0xC3:
        return True, pos
    elif tag in _FIXED:
        fmt, size = _FIXED[tag]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    elif tag in _LEN:
        kind, fmt, size = _LEN[tag]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += size
    else:
        raise ValueError(f"unsupported msgpack type 0x{tag:02x}")
    if kind == "str":
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if kind == "bin":
        return buf[pos:pos + n], pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            x, pos = _unpack(buf, pos)
            items.append(_owned(x))
        return items, pos
    d = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        d[k], pos = _unpack(buf, pos)
    if d.get("__nd__") == 1:
        return _as_array(d), pos
    return {k: _owned(v) for k, v in d.items()}, pos


def unpack_record(data) -> Dict[str, Any]:
    buf = memoryview(data).cast("B")
    value, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing bytes after the record")
    return _owned(value)


# ------------------------------------------------------------------ files

class RecordWriter:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")
        self._f.write(MAGIC + struct.pack("<I", VERSION))
        self._offsets: List[int] = []

    def write(self, record: Dict[str, Any]) -> None:
        payload = pack_record(record)
        self._offsets.append(self._f.tell())
        self._f.write(struct.pack("<Q", len(payload)))
        self._f.write(payload)

    def close(self) -> None:
        index_offset = self._f.tell()
        self._f.write(struct.pack(f"<{len(self._offsets)}Q", *self._offsets))
        self._f.write(struct.pack("<QQ", len(self._offsets), index_offset))
        self._f.write(TRAILER_MAGIC)
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    """Random-access mmap reader. Thread-safe for reads."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[:4] != MAGIC:
            raise ValueError(f"{path}: bad magic")
        if self._mm[-4:] != TRAILER_MAGIC:
            raise ValueError(f"{path}: bad trailer (truncated file?)")
        n, index_offset = struct.unpack("<QQ", self._mm[-20:-4])
        self._n = n
        self._offsets = np.frombuffer(self._mm, dtype="<u8", count=n,
                                      offset=index_offset)
        self._view = memoryview(self._mm)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> Dict[str, Any]:
        off = int(self._offsets[i])
        (length,) = struct.unpack_from("<Q", self._mm, off)
        return unpack_record(self._view[off + 8: off + 8 + length])

    def payload(self, i: int) -> bytes:
        """Record i's bytes."""
        off = int(self._offsets[i])
        (length,) = struct.unpack_from("<Q", self._mm, off)
        return self._mm[off + 8: off + 8 + length]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for i in range(self._n):
            yield self[i]

    def close(self) -> None:
        # decoded arrays are views into the mmap; closing it while they are
        # alive raises BufferError, so leave the mapping to the GC then
        self._offsets = None
        try:
            self._view.release()
            self._mm.close()
        except BufferError:
            pass
        self._file.close()


def write_records(path: str, records) -> int:
    n = 0
    with RecordWriter(path) as w:
        for r in records:
            w.write(r)
            n += 1
    return n
