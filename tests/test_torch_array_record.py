"""The port's ArrayRecord reader and writer (k3m_tpu_torch/data/
array_record.py, runtime/arrayrecord.cc) against `array_record`'s own
reader and writer and the JAX package's ArrayRecordStore and
write_array_records, on records written here, on the CPU:

  * a file the port writes is read by array_record's ArrayRecordReader,
    by grain's data source and by the JAX ArrayRecordStore, record for
    record; a file the JAX package writes (and array_record's files of
    other group sizes, uncompressed too) is read by the port payload for
    payload;
  * HighwayHash-64 under the Riegeli key holds on the two vectors every
    file carries and on every block and chunk header of a file that
    array_record wrote;
  * records that straddle the 64 KiB blocks, a ~300 KB one among small
    ones, in both directions;
  * a flipped byte in a chunk header, a chunk's data or a block header is
    refused by name; no zstd, or no compiler, raises by name.
"""

import ctypes
import struct

import numpy as np
import pytest

from array_record.python.array_record_module import ArrayRecordReader
from array_record.python.array_record_module import ArrayRecordWriter as TheirWriter
from k3m_tpu.data import grain_pipeline as jgrain
from k3m_tpu.data.records import pack_record as jax_pack
from k3m_tpu_torch import runtime
from k3m_tpu_torch.data import array_record as ar
from k3m_tpu_torch.data.records import pack_record
from tests.test_torch_data import _item

BLOCK = ar.BLOCK


@pytest.fixture(scope="module")
def records():
    """Small records and one of ~300 KB (36 x 2048 fp32 features) among
    them."""
    rng = np.random.default_rng(0)
    recs = [_item(rng, i) for i in range(12)]
    big = dict(recs[5], item_id="big", num_boxes=36,
               boxes=rng.random((36, 4), dtype=np.float32),
               features=rng.random((36, 2048), dtype=np.float32),
               cls_prob=rng.random((36, 7), dtype=np.float32))
    return recs[:5] + [big] + recs[5:]


@pytest.fixture(scope="module")
def payloads():
    """Raw payloads whose chunks cross the block boundaries in every way:
    empty, tiny, one that ends a chunk near a boundary, several blocks'
    worth, random (incompressible) and repetitive bytes."""
    rng = np.random.default_rng(1)
    sizes = [10, 40000, 0, 300000, 5, 65000, BLOCK - 64 - 40 - 20, 7, 120000, 3]
    sizes += rng.integers(1, 90000, 12).tolist()
    out = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in sizes]
    out[1] = b"ab" * 20000
    return out


def _hash(data: bytes) -> int:
    return runtime.library().k3mar_hash(ar._ptr(data), len(data))


def _walk(path):
    """Every chunk of a file, by the Riegeli layout alone: [(begin, end,
    header bytes, data bytes)], each block header checked on the way."""
    raw = open(path, "rb").read()
    lib = runtime.library()

    def logical(begin, n):
        out, pos = bytearray(), begin
        while n:
            if pos % BLOCK == 0:
                pos += 24
            take = min(n, BLOCK - pos % BLOCK)
            out += raw[pos:pos + take]
            pos, n = pos + take, n - take
        return bytes(out)

    chunks, pos = [], 0
    while pos < len(raw):
        head = logical(pos, 40)
        size, type_count = struct.unpack_from("<Q", head, 8)[0], struct.unpack_from(
            "<Q", head, 24)[0]
        end = lib.k3mar_chunk_end(pos, size, type_count >> 8)
        chunks.append((pos, end, head, logical(pos, 40 + size)[40:]))
        pos = end
    assert pos == len(raw) and len(raw) % BLOCK == 0
    for b in range(0, len(raw), BLOCK):
        begin, end = next((c[0], c[1]) for c in chunks if c[0] <= b < c[1])
        assert struct.unpack_from("<QQ", raw, b + 8) == (b - begin, end - b)
        assert struct.unpack_from("<Q", raw, b)[0] == _hash(raw[b + 8:b + 24])
    return chunks


def test_port_file_is_read_by_array_record_and_jax(tmp_path, records):
    """array_record's reader, grain's data source and the JAX
    ArrayRecordStore read the port's file record for record; the writer
    records the options string array_record writes."""
    import grain.python as grain
    path = str(tmp_path / "port.array_record")
    assert ar.write_array_records(path, records) == len(records)
    want = [pack_record(r) for r in records]
    reader = ArrayRecordReader(path)
    assert reader.read_all() == want
    assert reader.writer_options_string() == ar.OPTIONS
    source = grain.ArrayRecordDataSource(path)
    assert [source[i] for i in range(len(source))] == want
    store = jgrain.ArrayRecordStore(path)
    assert [jax_pack(store[i]) for i in range(len(store))] == want
    mine = ar.ArrayRecordStore(path)
    assert [mine.payload(i) for i in range(len(mine))] == want
    assert mine[-1]["item_id"] == records[-1]["item_id"]


def test_jax_file_is_read_by_the_port(tmp_path, records):
    """write_array_records of the JAX package, then array_record's writer at
    group sizes 3 and 2 (uncompressed): the port reads every payload."""
    path = str(tmp_path / "jax.array_record")
    assert jgrain.write_array_records(path, records) == len(records)
    want = [jax_pack(r) for r in records]
    store = ar.ArrayRecordStore(path)
    assert len(store) == len(records)
    assert [store.payload(i) for i in range(len(store))] == want
    for i in (0, 5, len(records) - 1):
        got, ref = store[i], records[i]
        assert got.keys() == ref.keys()
        for k in ref:
            if isinstance(ref[k], np.ndarray):
                assert got[k].dtype == ref[k].dtype and got[k].tobytes() == ref[k].tobytes()
            else:
                assert got[k] == ref[k]
    for options in ("group_size:3", "group_size:2,uncompressed"):
        other = str(tmp_path / f"{options[11]}.array_record")
        writer = TheirWriter(other, options)
        for p in want:
            writer.write(p)
        writer.close()
        store = ar.ArrayRecordStore(other)
        assert [store.payload(i) for i in range(len(store))] == want, options
        assert store.writer_options.startswith(options.split(",")[0])


def test_highwayhash_vectors_and_every_header_of_an_array_record_file(tmp_path, payloads):
    """HighwayHash-64 keyed by "Riegeli/records\\n" twice: the empty input's
    hash (the signature chunk's data hash, bytes 0x28-0x2f of every file)
    and the first block header's (bytes 0-7, over 0u64, 64u64); then every
    block header, chunk header and chunk data hash of a file array_record
    wrote, and the port's framing of each chunk equal to its bytes."""
    assert _hash(b"") == 0x72C3B1E9C0139FE1
    assert _hash(struct.pack("<QQ", 0, 64)).to_bytes(8, "little") == bytes.fromhex(
        "83af70d10d884a3f")
    path = str(tmp_path / "theirs.array_record")
    writer = TheirWriter(path, "group_size:1")
    for p in payloads:
        writer.write(p)
    writer.close()
    raw = open(path, "rb").read()
    assert raw[:8] == bytes.fromhex("83af70d10d884a3f")
    assert raw[0x28:0x30] == bytes.fromhex("e19f13c0e9b1c372")
    lib = runtime.library()
    chunks = _walk(path)
    assert len(chunks) == len(payloads) + 5   # signature, footer, padding, postscript, padding
    for begin, end, head, data in chunks:
        assert struct.unpack_from("<Q", head)[0] == _hash(head[8:])
        assert struct.unpack_from("<Q", head, 16)[0] == _hash(data)
        kind, count = head[24], struct.unpack_from("<Q", head, 24)[0] >> 8
        decoded = struct.unpack_from("<Q", head, 32)[0]
        out = np.empty(end - begin, np.uint8)
        assert lib.k3mar_frame(begin, kind, count, decoded, ar._ptr(data), len(data),
                               ar._ptr(out), out.size) == out.size
        assert out.tobytes() == raw[begin:end], (begin, chr(kind))


def test_records_across_block_boundaries_both_ways(tmp_path, payloads):
    """Payloads whose chunks straddle 64 KiB blocks (and one of 300 KB
    spanning several): the port's file read by array_record and walked
    chunk by chunk, array_record's file read by the port."""
    mine = str(tmp_path / "port.array_record")
    with ar.ArrayRecordWriter(mine) as w:
        for p in payloads:
            w.write_payload(p)
    assert ArrayRecordReader(mine).read_all() == payloads
    chunks = _walk(mine)
    assert sum(1 for b, e, *_ in chunks if b // BLOCK != (e - 1) // BLOCK) >= 8
    theirs = str(tmp_path / "theirs.array_record")
    writer = TheirWriter(theirs, "group_size:1")
    for p in payloads:
        writer.write(p)
    writer.close()
    store = ar.ArrayRecordStore(theirs)
    assert [store.payload(i) for i in range(len(store))] == payloads
    empty = str(tmp_path / "empty.array_record")
    ar.ArrayRecordWriter(empty).close()
    assert ArrayRecordReader(empty).num_records() == 0 and len(ar.ArrayRecordStore(empty)) == 0


@pytest.mark.parametrize("where,match", [
    ("data", "chunk data's hash does not match"),
    ("header", "chunk header's hash does not match"),
    ("block", "block header that does not match"),
])
def test_a_flipped_byte_is_refused_by_name(tmp_path, payloads, where, match):
    """One byte flipped in a record chunk's data, in its header, or in the
    block header inside a chunk that crosses a boundary: reading that
    record raises ArrayRecordError saying which."""
    path = tmp_path / "f.array_record"
    with ar.ArrayRecordWriter(str(path)) as w:
        for p in payloads:
            w.write_payload(p)
    chunks = _walk(str(path))
    i = 3                                          # the 300 KB record
    begin, end, _, _ = chunks[1 + i]
    assert end - begin > 2 * BLOCK
    head = begin + (24 if begin % BLOCK == 0 else 0)
    at = {"data": head + 40 + 1000, "header": head + 9,
          "block": (begin // BLOCK + 1) * BLOCK + 12}[where]
    raw = bytearray(path.read_bytes())
    raw[at] ^= 0x10
    path.write_bytes(bytes(raw))
    store = ar.ArrayRecordStore(str(path))
    assert store.payload(0) == payloads[0]
    with pytest.raises(ar.ArrayRecordError, match=match):
        store.payload(i)


def test_no_zstd_and_no_compiler_raise_by_name(tmp_path, monkeypatch):
    """Without libzstd the writer raises ZstdUnavailable; without g++ (the
    library not built yet) the store raises NativeUnavailable: no other
    path is taken."""
    path = str(tmp_path / "x.array_record")
    runtime.library()                    # built and loaded before CDLL is taken away
    with monkeypatch.context() as mp:
        mp.setattr(ar, "_zstd", None)
        mp.setattr(ctypes, "CDLL", lambda name: (_ for _ in ()).throw(OSError(name)))
        with pytest.raises(ar.ZstdUnavailable, match="libzstd.so.1"):
            ar.ArrayRecordWriter(path)
    ar.write_array_records(path, [])
    with monkeypatch.context() as mp:
        mp.setattr(runtime, "_lib", None)
        mp.setattr(runtime, "_error", None)
        mp.setattr(runtime, "BUILD_ROOT", tmp_path / "build")
        mp.setattr(runtime.shutil, "which", lambda name: None)
        with pytest.raises(runtime.NativeUnavailable, match="g\\+\\+ not found"):
            ar.ArrayRecordStore(path)
    with pytest.raises(FileNotFoundError):
        ar.ArrayRecordStore(str(tmp_path / "missing.array_record"))
