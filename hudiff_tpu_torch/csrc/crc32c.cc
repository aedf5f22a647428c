// CRC-32C (Castagnoli), the checksum of the OCDBT manifests and B-tree nodes
// that hudiff_tpu_torch/training/ocdbt.py reads; built by
// hudiff_tpu_torch/native/__init__.py.

#include <cstddef>
#include <cstdint>

namespace {

struct Crc32cTable {
  uint32_t t[256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[i] = c;
    }
  }
};

}  // namespace

extern "C" {

uint32_t hd_crc32c(const uint8_t* p, size_t n) {
  static const Crc32cTable table;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table.t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
