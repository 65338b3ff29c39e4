// TIFF-variant LZW codec (MSB-first bit packing, early-change width bumps),
// on the host.
//
// A copy of octseg's mask-TIFF codec. octseg_torch/data/tiffio.py calls it
// through ctypes for every LZW strip it reads or writes, and keeps its
// Python codec as the plain version the tests hold this one to, byte for
// byte; the training loader (dataloader.cc) decodes its masks with it.
//
// Conventions of libtiff and tifffile: the decoder widens at table size
// (1<<nbits)-1, so the encoder's first wide code is (1<<nbits)-1; the
// encoder emits CLEAR when the table reaches 4094.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;

struct BitWriter {
  std::vector<uint8_t>* out;
  uint64_t buf = 0;
  int bits = 0;
  void emit(uint32_t code, int nbits) {
    buf = (buf << nbits) | code;
    bits += nbits;
    while (bits >= 8) {
      bits -= 8;
      out->push_back(static_cast<uint8_t>((buf >> bits) & 0xFF));
    }
  }
  void flush() {
    if (bits > 0) {
      out->push_back(static_cast<uint8_t>((buf << (8 - bits)) & 0xFF));
      bits = 0;
    }
  }
};

}  // namespace

extern "C" {

// Encode `n` bytes from `src`. Writes up to the caller-provided capacity
// `cap` into `dst`; returns the number of bytes written, or -1 if dst was
// too small. A safe capacity is n * 1.5 + 64.
int64_t octseg_lzw_encode(const uint8_t* src, int64_t n, uint8_t* dst,
                          int64_t cap) {
  std::vector<uint8_t> out;
  out.reserve(static_cast<size_t>(n) + 64);
  BitWriter w{&out};

  // Hash-table based string table: key = (prefix_code << 8) | next_byte.
  // 4096 max entries; open addressing over a power-of-two table.
  constexpr int kHashBits = 13;
  constexpr int kHashSize = 1 << kHashBits;  // 8192
  int32_t hash_key[kHashSize];
  int16_t hash_code[kHashSize];

  auto reset_table = [&]() {
    std::memset(hash_key, 0xFF, sizeof(hash_key));  // -1 sentinel
  };

  reset_table();
  int next_code = 258;
  int nbits = 9;
  w.emit(kClear, nbits);

  if (n == 0) {
    w.emit(kEoi, nbits);
    w.flush();
    if (static_cast<int64_t>(out.size()) > cap) return -1;
    std::memcpy(dst, out.data(), out.size());
    return static_cast<int64_t>(out.size());
  }

  int32_t prefix = src[0];
  for (int64_t i = 1; i < n; ++i) {
    const uint8_t c = src[i];
    const int32_t key = (prefix << 8) | c;
    // probe
    uint32_t h = (static_cast<uint32_t>(key) * 0x9E3779B1u) >> (32 - kHashBits);
    bool found = false;
    while (hash_key[h] != -1) {
      if (hash_key[h] == key) {
        prefix = hash_code[h];
        found = true;
        break;
      }
      h = (h + 1) & (kHashSize - 1);
    }
    if (found) continue;

    w.emit(static_cast<uint32_t>(prefix), nbits);
    hash_key[h] = key;
    hash_code[h] = static_cast<int16_t>(next_code);
    ++next_code;
    if (nbits < 12 && next_code == (1 << nbits)) {
      ++nbits;
    } else if (nbits == 12 && next_code == (1 << 12) - 2) {
      w.emit(kClear, nbits);
      reset_table();
      next_code = 258;
      nbits = 9;
    }
    prefix = c;
  }
  w.emit(static_cast<uint32_t>(prefix), nbits);
  w.emit(kEoi, nbits);
  w.flush();

  if (static_cast<int64_t>(out.size()) > cap) return -1;
  std::memcpy(dst, out.data(), out.size());
  return static_cast<int64_t>(out.size());
}

// Decode `n` bytes from `src` into `dst` (capacity `cap` = exact expected
// output size, callers know it from the IFD). Returns bytes written or -1 on
// malformed input / overflow.
int64_t octseg_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                          int64_t cap) {
  // String table as (prefix_code, last_byte, length) triples; materialize
  // strings by walking prefixes backwards.
  int16_t prefix[4096];
  uint8_t last[4096];
  int32_t length[4096];
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1;
    last[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }

  int table_len = 258;
  int nbits = 9;
  int64_t bitpos = 0;
  const int64_t total_bits = n * 8;
  int32_t prev = -1;
  int64_t written = 0;

  auto emit_string = [&](int code, int64_t extra) -> int64_t {
    // Writes string for `code` (+ optional repeat of its first byte when
    // extra == 1 for the KwKwK case handled by caller) at dst+written.
    const int64_t len = length[code];
    if (written + len + extra > cap) return -1;
    int64_t pos = written + len;
    int c = code;
    while (c >= 0) {
      dst[--pos] = last[c];
      c = prefix[c];
    }
    return len;
  };

  while (bitpos + nbits <= total_bits) {
    const int64_t byte_idx = bitpos >> 3;
    uint32_t window = 0;
    // assemble up to 4 bytes (bounds-safe near the tail)
    for (int k = 0; k < 4; ++k) {
      window <<= 8;
      if (byte_idx + k < n) window |= src[byte_idx + k];
    }
    const int shift = 32 - static_cast<int>(bitpos & 7) - nbits;
    const int code = (window >> shift) & ((1 << nbits) - 1);
    bitpos += nbits;

    if (code == kEoi) break;
    if (code == kClear) {
      table_len = 258;
      nbits = 9;
      prev = -1;
      continue;
    }

    if (prev < 0) {
      if (code >= 256) return -1;
      if (written + 1 > cap) return -1;
      dst[written++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }

    int emitted_code;
    if (code < table_len) {
      emitted_code = code;
      const int64_t len = emit_string(code, 0);
      if (len < 0) return -1;
      written += len;
      if (table_len < 4096) {
        prefix[table_len] = static_cast<int16_t>(prev);
        last[table_len] = dst[written - len];  // first byte of current string
        length[table_len] = length[prev] + 1;
        ++table_len;
      }
    } else if (code == table_len && table_len < 4096) {
      // KwKwK: new entry = prev string + its first byte.
      const int64_t len = emit_string(prev, 1);
      if (len < 0) return -1;
      const uint8_t first = dst[written];
      written += len;
      if (written + 1 > cap) return -1;
      dst[written++] = first;
      prefix[table_len] = static_cast<int16_t>(prev);
      last[table_len] = first;
      length[table_len] = length[prev] + 1;
      emitted_code = table_len;
      ++table_len;
    } else {
      return -1;  // corrupt stream
    }
    prev = emitted_code;

    if (table_len >= (1 << nbits) - 1 && nbits < 12) ++nbits;
  }
  return written;
}

}  // extern "C"
