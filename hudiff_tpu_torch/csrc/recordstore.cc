// Copied from csrc/recordstore.cc; built by hudiff_tpu_torch/native/__init__.py.
// Native reader for the framework's RecordStore format (see
// hudiff_tpu_torch/data/store.py): `<name>.bin` payload + `<name>.idx` offsets.
// Provides GIL-free batch gathers for the input pipeline.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr char kMagic[8] = {'H', 'D', 'R', 'S', '0', '0', '0', '1'};

struct Store {
  int fd = -1;
  const uint8_t* data = nullptr;
  size_t size = 0;
  std::vector<std::pair<uint64_t, uint64_t>> entries;  // offset, length
};

}  // namespace

extern "C" {

void* hd_rs_open(const char* path) {
  std::string base(path);
  FILE* idx = fopen((base + ".idx").c_str(), "rb");
  if (!idx) return nullptr;
  char magic[8];
  uint64_t n = 0;
  if (fread(magic, 1, 8, idx) != 8 || memcmp(magic, kMagic, 8) != 0 ||
      fread(&n, 8, 1, idx) != 1) {
    fclose(idx);
    return nullptr;
  }
  auto* st = new Store();
  st->entries.resize(n);
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t rec[2];
    if (fread(rec, 8, 2, idx) != 2) {
      fclose(idx);
      delete st;
      return nullptr;
    }
    st->entries[i] = {rec[0], rec[1]};
  }
  fclose(idx);

  st->fd = open((base + ".bin").c_str(), O_RDONLY);
  if (st->fd < 0) {
    delete st;
    return nullptr;
  }
  struct stat sb;
  fstat(st->fd, &sb);
  st->size = static_cast<size_t>(sb.st_size);
  if (st->size > 0) {
    void* p = mmap(nullptr, st->size, PROT_READ, MAP_PRIVATE, st->fd, 0);
    if (p == MAP_FAILED) {
      close(st->fd);
      delete st;
      return nullptr;
    }
    st->data = static_cast<const uint8_t*>(p);
    madvise(p, st->size, MADV_RANDOM);
  }
  return st;
}

int64_t hd_rs_len(void* h) {
  return static_cast<Store*>(h)->entries.size();
}

// Record length for idx (to size buffers).
int64_t hd_rs_record_len(void* h, int64_t idx) {
  auto* st = static_cast<Store*>(h);
  if (idx < 0 || static_cast<size_t>(idx) >= st->entries.size()) return -1;
  return static_cast<int64_t>(st->entries[idx].second);
}

// Copy one record into out (caller sized via hd_rs_record_len).
int hd_rs_get(void* h, int64_t idx, uint8_t* out) {
  auto* st = static_cast<Store*>(h);
  if (idx < 0 || static_cast<size_t>(idx) >= st->entries.size()) return -1;
  const auto [off, len] = st->entries[idx];
  memcpy(out, st->data + off, len);
  return 0;
}

// Gather k records into a contiguous buffer; out_offsets[k+1] receives the
// running offsets. Returns total bytes or -1.
int64_t hd_rs_gather(void* h, const int64_t* ids, int32_t k, uint8_t* out,
                     int64_t out_capacity, int64_t* out_offsets) {
  auto* st = static_cast<Store*>(h);
  int64_t pos = 0;
  out_offsets[0] = 0;
  for (int32_t i = 0; i < k; ++i) {
    const int64_t idx = ids[i];
    if (idx < 0 || static_cast<size_t>(idx) >= st->entries.size()) return -1;
    const auto [off, len] = st->entries[idx];
    if (pos + static_cast<int64_t>(len) > out_capacity) return -1;
    memcpy(out + pos, st->data + off, len);
    pos += static_cast<int64_t>(len);
    out_offsets[i + 1] = pos;
  }
  return pos;
}

void hd_rs_close(void* h) {
  auto* st = static_cast<Store*>(h);
  if (st->data) munmap(const_cast<uint8_t*>(st->data), st->size);
  if (st->fd >= 0) close(st->fd);
  delete st;
}

}  // extern "C"
