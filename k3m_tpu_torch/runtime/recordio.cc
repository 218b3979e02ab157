// Native K3MR record reader: zero-copy mmap random access.
//
// The port's copy of k3m_tpu/runtime/recordio.cc. The reference's data
// path rides on LMDB's C library via tensorpack
// (concept_cap_dataset_struc.py:228-231). This is the equivalent native
// component for the K3MR format (see k3m_tpu_torch/data/records.py for the
// layout):
//
//   [magic "K3MR"][u32 version]
//   [u64 len][payload] * N
//   [u64 offset] * N
//   [u64 N][u64 index_offset][magic "K3MX"]
//
// Exposed through a small C ABI consumed via ctypes
// (k3m_tpu_torch/runtime/__init__.py). Readers are thread-safe (read-only
// mmap). Built as part of preprocess.cc, which includes this file.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Reader {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t n = 0;
  const uint64_t* offsets = nullptr;  // points into the mapping
};

inline uint64_t read_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, sizeof(v));
  return v;  // little-endian hosts only (x86/ARM)
}

}  // namespace

extern "C" {

void* k3mr_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0 || st.st_size < 32) {
    ::close(fd);
    return nullptr;
  }
  void* map = ::mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const uint8_t* base = static_cast<const uint8_t*>(map);
  size_t size = st.st_size;
  if (std::memcmp(base, "K3MR", 4) != 0 ||
      std::memcmp(base + size - 4, "K3MX", 4) != 0) {
    ::munmap(map, size);
    ::close(fd);
    return nullptr;
  }
  uint64_t n = read_u64(base + size - 20);
  uint64_t index_offset = read_u64(base + size - 12);
  // each bound apart, so that a garbage count cannot wrap the sum
  if (n > size / 8 || index_offset > size || index_offset + n * 8 > size) {
    ::munmap(map, size);
    ::close(fd);
    return nullptr;
  }
  Reader* r = new Reader();
  r->fd = fd;
  r->base = base;
  r->size = size;
  r->n = n;
  r->offsets = reinterpret_cast<const uint64_t*>(base + index_offset);
  // advise the kernel we will read records in mostly-random order
  ::madvise(map, size, MADV_WILLNEED);
  return r;
}

int64_t k3mr_count(void* handle) {
  if (!handle) return -1;
  return static_cast<int64_t>(static_cast<Reader*>(handle)->n);
}

// Returns payload length and sets *out to the payload pointer (zero-copy,
// valid until k3mr_close). Negative on error.
int64_t k3mr_record(void* handle, int64_t i, const uint8_t** out) {
  if (!handle) return -1;
  Reader* r = static_cast<Reader*>(handle);
  if (i < 0 || static_cast<uint64_t>(i) >= r->n) return -2;
  uint64_t off = r->offsets[i];
  if (off + 8 > r->size) return -3;
  uint64_t len = read_u64(r->base + off);
  if (off + 8 + len > r->size) return -4;
  *out = r->base + off + 8;
  return static_cast<int64_t>(len);
}

void k3mr_close(void* handle) {
  if (!handle) return;
  Reader* r = static_cast<Reader*>(handle);
  ::munmap(const_cast<uint8_t*>(r->base), r->size);
  ::close(r->fd);
  delete r;
}

}  // extern "C"
