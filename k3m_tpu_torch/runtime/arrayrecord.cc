// ArrayRecord files: the Riegeli framing (block headers, chunk headers,
// HighwayHash-64) of the files that k3m_tpu/data/grain_pipeline.py writes
// through array_record's ArrayRecordWriter and reads through grain's
// ArrayRecordDataSource.
//
// A Riegeli file is cut into 64 KiB blocks; each block starts with a
// 24-byte header
//   [u64 hash of the next 16 bytes][u64 previous_chunk][u64 next_chunk]
// where previous_chunk is the distance from the start of the chunk that
// the boundary interrupts (or that starts on it) back to the boundary and
// next_chunk the distance from the boundary to that chunk's end. A chunk is
// a 40-byte header
//   [u64 header hash of the next 32 bytes][u64 data size][u64 data hash]
//   [u8 type, 7 bytes record count][u64 decoded data size]
// and its data; the block headers are inserted wherever the chunk crosses
// a boundary. A chunk ends at max(its bytes with the block headers,
// begin + record count), zero-filled. Hashes are HighwayHash-64 keyed by
// "Riegeli/records\n" twice.
//
// Compression (zstd) and the simple-chunk and protobuf layout above the
// framing are in k3m_tpu_torch/data/array_record.py; this file does what
// runs over every byte of a record: the hashes and the block-header walk,
// for writing (k3mar_frame) and for reading (k3mar_chunk_header,
// k3mar_chunk_data), plus the varint and index-record decoding of a
// footer. Built as part of preprocess.cc, which includes this file.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace arrec {

constexpr uint64_t kBlock = 1 << 16;
constexpr uint64_t kBlockHeader = 24;
constexpr uint64_t kChunkHeader = 40;
constexpr uint64_t kKey[4] = {0x2f696c6567656952ull, 0x0a7364726f636572ull,
                              0x2f696c6567656952ull, 0x0a7364726f636572ull};

// ------------------------------------------------------ HighwayHash-64
// The portable reference algorithm (github.com/google/highwayhash,
// c/highwayhash.c).

struct HH {
  uint64_t v0[4], v1[4], mul0[4], mul1[4];
};

inline uint64_t rot32(uint64_t x) { return (x >> 32) | (x << 32); }

inline void hh_reset(HH* s) {
  static const uint64_t m0[4] = {0xdbe6d5d5fe4cce2full, 0xa4093822299f31d0ull,
                                 0x13198a2e03707344ull, 0x243f6a8885a308d3ull};
  static const uint64_t m1[4] = {0x3bd39e10cb0ef593ull, 0xc0acf169b5f18a8cull,
                                 0xbe5466cf34e90c6cull, 0x452821e638d01377ull};
  for (int i = 0; i < 4; ++i) {
    s->mul0[i] = m0[i];
    s->mul1[i] = m1[i];
    s->v0[i] = m0[i] ^ kKey[i];
    s->v1[i] = m1[i] ^ rot32(kKey[i]);
  }
}

inline void zipper_merge_add(uint64_t v1, uint64_t v0, uint64_t* add1, uint64_t* add0) {
  *add0 += (((v0 & 0xff000000ull) | (v1 & 0xff00000000ull)) >> 24) |
           (((v0 & 0xff0000000000ull) | (v1 & 0xff000000000000ull)) >> 16) |
           (v0 & 0xff0000ull) | ((v0 & 0xff00ull) << 32) |
           ((v1 & 0xff00000000000000ull) >> 8) | (v0 << 56);
  *add1 += (((v1 & 0xff000000ull) | (v0 & 0xff00000000ull)) >> 24) |
           (v1 & 0xff0000ull) | ((v1 & 0xff0000000000ull) >> 16) |
           ((v1 & 0xff00ull) << 24) | ((v0 & 0xff000000000000ull) >> 8) |
           ((v1 & 0xffull) << 48) | (v0 & 0xff00000000000000ull);
}

inline void hh_update(const uint64_t lanes[4], HH* s) {
  for (int i = 0; i < 4; ++i) {
    s->v1[i] += s->mul0[i] + lanes[i];
    s->mul0[i] ^= (s->v1[i] & 0xffffffffull) * (s->v0[i] >> 32);
    s->v0[i] += s->mul1[i];
    s->mul1[i] ^= (s->v0[i] & 0xffffffffull) * (s->v1[i] >> 32);
  }
  zipper_merge_add(s->v1[1], s->v1[0], &s->v0[1], &s->v0[0]);
  zipper_merge_add(s->v1[3], s->v1[2], &s->v0[3], &s->v0[2]);
  zipper_merge_add(s->v0[1], s->v0[0], &s->v1[1], &s->v1[0]);
  zipper_merge_add(s->v0[3], s->v0[2], &s->v1[3], &s->v1[2]);
}

inline uint64_t load_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86/ARM)
}

inline void store_u64(uint8_t* p, uint64_t v) { std::memcpy(p, &v, 8); }

inline void hh_packet(const uint8_t* p, HH* s) {
  const uint64_t lanes[4] = {load_u64(p), load_u64(p + 8), load_u64(p + 16),
                             load_u64(p + 24)};
  hh_update(lanes, s);
}

inline uint32_t rotl32(uint32_t x, unsigned c) { return (x << c) | (x >> (32 - c)); }

inline void hh_remainder(const uint8_t* bytes, size_t size_mod32, HH* s) {
  const size_t size_mod4 = size_mod32 & 3;
  const uint8_t* remainder = bytes + (size_mod32 & ~size_t{3});
  uint8_t packet[32] = {0};
  for (int i = 0; i < 4; ++i) s->v0[i] += (uint64_t{size_mod32} << 32) + size_mod32;
  for (int i = 0; i < 4; ++i) {  // size_mod32 is 1-31 here
    const uint32_t lo = static_cast<uint32_t>(s->v1[i]);
    const uint32_t hi = static_cast<uint32_t>(s->v1[i] >> 32);
    s->v1[i] = uint64_t{rotl32(lo, size_mod32)} | (uint64_t{rotl32(hi, size_mod32)} << 32);
  }
  std::memcpy(packet, bytes, remainder - bytes);
  if (size_mod32 & 16) {
    for (int i = 0; i < 4; ++i) packet[28 + i] = remainder[i + size_mod4 - 4];
  } else if (size_mod4) {
    packet[16] = remainder[0];
    packet[17] = remainder[size_mod4 >> 1];
    packet[18] = remainder[size_mod4 - 1];
  }
  hh_packet(packet, s);
}

inline uint64_t highway64(const uint8_t* data, size_t n) {
  HH s;
  hh_reset(&s);
  const size_t packets = n / 32;
  for (size_t i = 0; i < packets; ++i) hh_packet(data + 32 * i, &s);
  if (n & 31) hh_remainder(data + 32 * packets, n & 31, &s);
  for (int r = 0; r < 4; ++r) {
    const uint64_t permuted[4] = {rot32(s.v0[2]), rot32(s.v0[3]), rot32(s.v0[0]),
                                  rot32(s.v0[1])};
    hh_update(permuted, &s);
  }
  return s.v0[0] + s.v1[0] + s.mul0[0] + s.mul1[0];
}

// ------------------------------------------------------ positions

// `pos` advanced by `length` bytes of chunk, skipping the block headers in
// the way (one at `pos` itself where it is a boundary).
inline uint64_t add_with_overhead(uint64_t pos, uint64_t length) {
  while (length > 0) {
    if (pos % kBlock == 0) pos += kBlockHeader;
    const uint64_t take = std::min(length, kBlock - pos % kBlock);
    pos += take;
    length -= take;
  }
  return pos;
}

inline uint64_t chunk_end(uint64_t begin, uint64_t data_size, uint64_t num_records) {
  return std::max(add_with_overhead(begin, kChunkHeader + data_size), begin + num_records);
}

inline void block_header(uint8_t* out, uint64_t previous_chunk, uint64_t next_chunk) {
  store_u64(out + 8, previous_chunk);
  store_u64(out + 16, next_chunk);
  store_u64(out, highway64(out + 8, 16));
}

struct File {
  int fd = -1;
  const uint8_t* base = nullptr;
  uint64_t size = 0;
};

// Copies `n` chunk bytes starting `skip` bytes into the chunk at `begin`
// (block headers left out) into `out`; checks every block header it passes
// against the chunk's extent. Returns false on a bad block header or a
// chunk past the end of the file.
inline bool gather(const File* f, uint64_t begin, uint64_t end, uint64_t skip, uint64_t n,
                   uint8_t* out) {
  uint64_t pos = begin, logical = 0;
  uint8_t expect[kBlockHeader];
  while (logical < skip + n) {
    if (pos % kBlock == 0) {
      if (pos + kBlockHeader > f->size) return false;
      block_header(expect, pos - begin, end - pos);
      if (std::memcmp(expect, f->base + pos, kBlockHeader) != 0) return false;
      pos += kBlockHeader;
    }
    const uint64_t take = std::min(skip + n - logical, kBlock - pos % kBlock);
    if (pos + take > f->size) return false;
    if (logical + take > skip) {
      const uint64_t from = logical < skip ? skip - logical : 0;
      std::memcpy(out + logical + from - skip, f->base + pos + from, take - from);
    }
    pos += take;
    logical += take;
  }
  return true;
}

}  // namespace arrec

extern "C" {

uint64_t k3mar_hash(const uint8_t* data, uint64_t n) { return arrec::highway64(data, n); }

// The end of a chunk of `data_size` bytes and `num_records` records that
// begins at `begin`.
uint64_t k3mar_chunk_end(uint64_t begin, uint64_t data_size, uint64_t num_records) {
  return arrec::chunk_end(begin, data_size, num_records);
}

// Writes into `out` the file bytes of the chunk that begins at `begin`:
// its header (hashes computed here), its data, the zeros up to its end,
// and a block header at every boundary in [begin, end). `out` must hold
// k3mar_chunk_end(begin, size, num_records) - begin bytes; returns that
// count, or -1 if `cap` is smaller.
int64_t k3mar_frame(uint64_t begin, uint32_t type, uint64_t num_records,
                    uint64_t decoded_size, const uint8_t* data, uint64_t size, uint8_t* out,
                    uint64_t cap) {
  using namespace arrec;
  const uint64_t end = chunk_end(begin, size, num_records);
  if (end - begin > cap) return -1;
  uint8_t header[kChunkHeader];
  store_u64(header + 8, size);
  store_u64(header + 16, highway64(data, size));
  store_u64(header + 24, (num_records << 8) | (type & 0xff));
  store_u64(header + 32, decoded_size);
  store_u64(header, highway64(header + 8, 32));
  uint64_t pos = begin, logical = 0;
  uint8_t* o = out;
  while (pos < end) {
    if (pos % kBlock == 0) {
      block_header(o, pos - begin, end - pos);
      o += kBlockHeader;
      pos += kBlockHeader;
      continue;
    }
    const uint64_t take = std::min(end - pos, kBlock - pos % kBlock);
    for (uint64_t done = 0; done < take;) {   // header, then data, then zeros
      const uint64_t at = logical + done;
      uint64_t n;
      if (at < kChunkHeader) {
        n = std::min(take - done, kChunkHeader - at);
        std::memcpy(o + done, header + at, n);
      } else if (at < kChunkHeader + size) {
        n = std::min(take - done, kChunkHeader + size - at);
        std::memcpy(o + done, data + (at - kChunkHeader), n);
      } else {
        n = take - done;
        std::memset(o + done, 0, n);
      }
      done += n;
    }
    o += take;
    pos += take;
    logical += take;
  }
  return static_cast<int64_t>(o - out);
}

void* k3mar_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0 || st.st_size < static_cast<off_t>(arrec::kBlockHeader +
                                                               arrec::kChunkHeader)) {
    ::close(fd);
    return nullptr;
  }
  void* map = ::mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* f = new arrec::File();
  f->fd = fd;
  f->base = static_cast<const uint8_t*>(map);
  f->size = static_cast<uint64_t>(st.st_size);
  return f;
}

uint64_t k3mar_size(void* handle) { return static_cast<arrec::File*>(handle)->size; }

// The header of the chunk at `begin`, checked against its hash and the
// block headers it crosses: out = {data size, type, record count, decoded
// size, chunk end}. Returns 0, -1 (past the end of the file or a bad block
// header) or -2 (the header's hash does not match).
int32_t k3mar_chunk_header(void* handle, uint64_t begin, uint64_t* out) {
  using namespace arrec;
  const File* f = static_cast<File*>(handle);
  uint8_t header[kChunkHeader];
  // the chunk's end is not known yet: check the block headers in the way
  // against the end the header gives, once it is read
  uint64_t pos = begin, got = 0;
  while (got < kChunkHeader) {
    if (pos % kBlock == 0) pos += kBlockHeader;
    const uint64_t take = std::min(kChunkHeader - got, kBlock - pos % kBlock);
    if (pos + take > f->size) return -1;
    std::memcpy(header + got, f->base + pos, take);
    pos += take;
    got += take;
  }
  if (load_u64(header) != highway64(header + 8, 32)) return -2;
  const uint64_t size = load_u64(header + 8), type_count = load_u64(header + 24);
  out[0] = size;
  out[1] = type_count & 0xff;
  out[2] = type_count >> 8;
  out[3] = load_u64(header + 32);
  if (size > f->size) return -1;
  out[4] = chunk_end(begin, size, out[2]);
  if (!gather(f, begin, out[4], 0, kChunkHeader, header)) return -1;
  return 0;
}

// The `size` data bytes of the chunk at `begin` that ends at `end` (from
// k3m_chunk_header), block headers left out, into `out`; checked against
// the data hash of the header. Returns 0, -1 (past the end of the file or
// a bad block header) or -3 (the data's hash does not match).
int32_t k3mar_chunk_data(void* handle, uint64_t begin, uint64_t end, uint64_t size,
                         uint8_t* out) {
  using namespace arrec;
  const File* f = static_cast<File*>(handle);
  uint8_t header[kChunkHeader];
  if (!gather(f, begin, end, 0, kChunkHeader, header)) return -1;
  if (!gather(f, begin, end, kChunkHeader, size, out)) return -1;
  if (load_u64(header + 16) != highway64(out, size)) return -3;
  return 0;
}

void k3mar_close(void* handle) {
  if (!handle) return;
  auto* f = static_cast<arrec::File*>(handle);
  ::munmap(const_cast<uint8_t*>(f->base), f->size);
  ::close(f->fd);
  delete f;
}

// Decodes the varints of `buf` into `out`; returns their count, or -1 (a
// varint runs past the end or past 64 bits) or -2 (more than `cap`).
int64_t k3mar_varints(const uint8_t* buf, uint64_t len, uint64_t* out, uint64_t cap) {
  uint64_t n = 0, i = 0;
  while (i < len) {
    uint64_t v = 0;
    int shift = 0;
    while (true) {
      if (i >= len || shift > 63) return -1;
      const uint8_t c = buf[i++];
      v |= uint64_t{c & 0x7fu} << shift;
      shift += 7;
      if (c < 0x80) break;
    }
    if (n >= cap) return -2;
    out[n++] = v;
  }
  return static_cast<int64_t>(n);
}

// Reads `n` ArrayRecord index records (protobuf: 1 chunk_offset, 2
// decoded_data_size, 3 num_records, each a varint) laid end to end in
// `values` with the byte sizes `sizes`, into offsets[] and counts[].
// Returns 0, or -(k + 1) where record k is malformed.
int64_t k3mar_index(const uint8_t* values, const uint64_t* sizes, int64_t n,
                    uint64_t* offsets, uint64_t* counts) {
  uint64_t at = 0;
  for (int64_t k = 0; k < n; ++k) {
    const uint64_t stop = at + sizes[k];
    offsets[k] = 0;
    counts[k] = 0;
    bool has_offset = false, has_count = false;
    while (at < stop) {
      uint64_t vals[2];
      uint64_t got = 0, i = at;
      while (got < 2 && i < stop) {   // the tag, then the value
        uint64_t v = 0;
        int shift = 0;
        while (true) {
          if (i >= stop || shift > 63) return -(k + 1);
          const uint8_t c = values[i++];
          v |= uint64_t{c & 0x7fu} << shift;
          shift += 7;
          if (c < 0x80) break;
        }
        vals[got++] = v;
      }
      if (got != 2 || (vals[0] & 7) != 0) return -(k + 1);   // varint fields only
      if (vals[0] >> 3 == 1) {
        offsets[k] = vals[1];
        has_offset = true;
      } else if (vals[0] >> 3 == 3) {
        counts[k] = vals[1];
        has_count = true;
      }
      at = i;
    }
    if (!has_offset || !has_count) return -(k + 1);
  }
  return 0;
}

}  // extern "C"
