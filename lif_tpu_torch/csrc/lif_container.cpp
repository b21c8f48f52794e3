// Native LIF container codec and PNG row unfilter (host code, not a kernel).
//
// A copy of lif_tpu/native/lif_container.cpp, which the port does not
// import, plus lif_png_unfilter. The hot path of a loader is scanning the
// binary field table of many LIF files (magic 0x1E1A at EOF-2, u32be
// region offset at EOF-6, then a (type, size, payload) record table —
// reference format semantics per src/LifLoader.ts:380-406). This library
// does the scan/validation in C++ and hands Python (ctypes) a flat table
// of field descriptors; payloads are never copied — Python slices the
// original buffer by offset.
//
// The PNG decoder of lif_tpu_torch/io/decode.py inflates with zlib and
// undoes the five row filters here: Average and Paeth depend on the
// unfiltered byte to their left, a serial chain along each row.
//
// Build: lif_tpu_torch/io/native.py (g++ -O2 -shared -fPIC, into
// lif_tpu_torch/_build/).
//
// C ABI:
//   int lif_parse(const uint8_t* data, uint64_t size,
//                 LifField* out_fields, uint32_t max_fields,
//                 uint32_t* out_count);
//     returns 0 on success, negative error codes otherwise.
//   int lif_validate(const uint8_t* data, uint64_t size);
//   uint64_t lif_write_size(uint64_t jpeg_size, const uint64_t* field_sizes,
//                           uint32_t n_fields);
//   int lif_write(const uint8_t* jpeg, uint64_t jpeg_size,
//                 const uint32_t* types, const uint8_t** payloads,
//                 const uint64_t* sizes, uint32_t n_fields,
//                 uint8_t* out, uint64_t out_capacity, uint64_t* out_size);
//   int lif_png_unfilter(const uint8_t* raw, uint64_t raw_size,
//                        uint32_t rows, uint32_t stride, uint32_t bpp,
//                        uint8_t* out);
//     raw: rows x (1 filter byte + stride bytes); out: rows x stride.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr uint16_t kMagic = 0x1E1A;

inline uint16_t read_u16be(const uint8_t* p) {
  return static_cast<uint16_t>((p[0] << 8) | p[1]);
}

inline uint32_t read_u32be(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
}

inline void write_u16be(uint8_t* p, uint16_t v) {
  p[0] = static_cast<uint8_t>(v >> 8);
  p[1] = static_cast<uint8_t>(v);
}

inline void write_u32be(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v >> 24);
  p[1] = static_cast<uint8_t>(v >> 16);
  p[2] = static_cast<uint8_t>(v >> 8);
  p[3] = static_cast<uint8_t>(v);
}

// the PNG specification's Paeth predictor (ISO/IEC 15948, 9.4)
inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a);
  const int pb = std::abs(p - b);
  const int pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

}  // namespace

extern "C" {

struct LifField {
  uint32_t field_type;
  uint32_t reserved;
  uint64_t offset;  // payload offset into the original buffer
  uint64_t size;    // payload size in bytes
};

enum LifError {
  LIF_OK = 0,
  LIF_ERR_TOO_SHORT = -1,
  LIF_ERR_BAD_MAGIC = -2,
  LIF_ERR_BAD_REGION = -3,
  LIF_ERR_TRUNCATED = -4,
  LIF_ERR_TOO_MANY_FIELDS = -5,
  LIF_ERR_CAPACITY = -6,
  LIF_ERR_FIELD_TOO_LARGE = -7,  // u32 field-table limits exceeded
  LIF_ERR_PNG_SIZE = -8,         // raw rows shorter than rows x (1 + stride)
  LIF_ERR_PNG_FILTER = -9,       // a row filter type outside 0..4
};

int lif_parse(const uint8_t* data, uint64_t size, LifField* out_fields,
              uint32_t max_fields, uint32_t* out_count) {
  if (out_count) *out_count = 0;
  if (size < 8) return LIF_ERR_TOO_SHORT;
  if (read_u16be(data + size - 2) != kMagic) return LIF_ERR_BAD_MAGIC;

  const uint64_t region_offset = read_u32be(data + size - 6);
  if (region_offset > size || region_offset < 6) return LIF_ERR_BAD_REGION;
  uint64_t pos = size - region_offset;
  if (pos + 4 > size) return LIF_ERR_BAD_REGION;

  const uint32_t count = read_u32be(data + pos);
  pos += 4;
  if (out_fields && count > max_fields) return LIF_ERR_TOO_MANY_FIELDS;

  for (uint32_t i = 0; i < count; ++i) {
    if (pos + 8 > size) return LIF_ERR_TRUNCATED;
    const uint32_t ftype = read_u32be(data + pos);
    const uint32_t fsize = read_u32be(data + pos + 4);
    pos += 8;
    if (pos + fsize > size) return LIF_ERR_TRUNCATED;
    if (out_fields) {
      out_fields[i].field_type = ftype;
      out_fields[i].reserved = 0;
      out_fields[i].offset = pos;
      out_fields[i].size = fsize;
    }
    pos += fsize;
  }
  if (out_count) *out_count = count;
  return LIF_OK;
}

int lif_validate(const uint8_t* data, uint64_t size) {
  return lif_parse(data, size, nullptr, 0, nullptr);
}

uint64_t lif_write_size(uint64_t jpeg_size, const uint64_t* field_sizes,
                        uint32_t n_fields) {
  uint64_t total = jpeg_size + 4;  // field count
  for (uint32_t i = 0; i < n_fields; ++i) total += 8 + field_sizes[i];
  return total + 6;  // region offset + magic
}

int lif_write(const uint8_t* jpeg, uint64_t jpeg_size, const uint32_t* types,
              const uint8_t** payloads, const uint64_t* sizes,
              uint32_t n_fields, uint8_t* out, uint64_t out_capacity,
              uint64_t* out_size) {
  // the on-disk field table stores sizes and the region offset as u32be:
  // refuse payloads or regions that would silently truncate
  uint64_t region_bytes = 4 + 6;  // field count + trailer
  for (uint32_t i = 0; i < n_fields; ++i) {
    if (sizes[i] > UINT32_MAX) return LIF_ERR_FIELD_TOO_LARGE;
    region_bytes += 8 + sizes[i];
    if (region_bytes > UINT32_MAX) return LIF_ERR_FIELD_TOO_LARGE;
  }
  const uint64_t need = lif_write_size(jpeg_size, sizes, n_fields);
  if (out_size) *out_size = need;
  if (need > out_capacity) return LIF_ERR_CAPACITY;

  uint64_t pos = 0;
  std::memcpy(out, jpeg, jpeg_size);
  pos += jpeg_size;

  const uint64_t region_start = pos;
  write_u32be(out + pos, n_fields);
  pos += 4;
  for (uint32_t i = 0; i < n_fields; ++i) {
    write_u32be(out + pos, types[i]);
    write_u32be(out + pos + 4, static_cast<uint32_t>(sizes[i]));
    pos += 8;
    std::memcpy(out + pos, payloads[i], sizes[i]);
    pos += sizes[i];
  }
  // region_offset counts from region start to EOF (region + 6-byte trailer)
  const uint64_t region_offset = (pos - region_start) + 6;
  write_u32be(out + pos, static_cast<uint32_t>(region_offset));
  write_u16be(out + pos + 4, kMagic);
  pos += 6;
  if (out_size) *out_size = pos;
  return LIF_OK;
}

int lif_png_unfilter(const uint8_t* raw, uint64_t raw_size, uint32_t rows,
                     uint32_t stride, uint32_t bpp, uint8_t* out) {
  if (raw_size < static_cast<uint64_t>(rows) * (1 + uint64_t{stride}))
    return LIF_ERR_PNG_SIZE;
  const uint8_t* prior = nullptr;  // the previous unfiltered row
  for (uint32_t r = 0; r < rows; ++r) {
    const uint8_t* f = raw + uint64_t{r} * (1 + uint64_t{stride});
    const uint8_t ftype = f[0];
    ++f;
    uint8_t* x = out + uint64_t{r} * stride;
    for (uint32_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? x[i - bpp] : 0;
      const int b = prior ? prior[i] : 0;
      const int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
      int pred;
      switch (ftype) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return LIF_ERR_PNG_FILTER;
      }
      x[i] = static_cast<uint8_t>(f[i] + pred);
    }
    prior = x;
  }
  return LIF_OK;
}

}  // extern "C"
