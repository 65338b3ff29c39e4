// Huffman entropy decoding of one sequential JPEG scan (baseline SOF0 and
// extended SOF1, 8-bit), on the host.
//
// octseg_torch/data/jpeg.py parses the markers, splits the scan's
// entropy-coded bytes at its restart markers and does everything after this
// stage (dequantization, IDCT, upsampling, colour conversion) in numpy. This
// file turns one scan into int16 coefficient blocks in natural (row-major)
// order, exactly as data/jpeg.py's Python decoder does; that decoder is its
// plain version and the tests hold the two equal.
//
// Semantics, as libjpeg's sequential decoder:
//   - the bit stream of a restart segment is its bytes with each FF 00
//     replaced by FF; the first FF not followed by 00 ends the segment's
//     data (a marker or fill), and zero bits are read after it;
//   - DC predictions restart at 0 in every segment;
//   - a block of a component with sampling h x v sits at block row
//     mcu_y * v + by, block column mcu_x * h + bx of that component's plane
//     (the caller passes h = v = 1 for a scan of one component, whose MCU is
//     one block).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 (octseg_torch/data/jpeg.py does it
// at first use). Plain C interface, loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// 16-bit lookahead table of a canonical Huffman code: entry (length << 8) |
// symbol for every 16-bit window that starts with that code; 0 where no
// code starts.
bool build_table(const uint8_t* bits, const uint8_t* vals, std::vector<uint16_t>* lut) {
  lut->assign(1 << 16, 0);
  uint32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len]; ++i, ++k) {
      if (k >= 256 || code >= (1u << len)) return false;
      uint32_t first = code << (16 - len), count = 1u << (16 - len);
      for (uint32_t j = 0; j < count; ++j)
        (*lut)[first + j] = static_cast<uint16_t>((len << 8) | vals[k]);
      ++code;
    }
    code <<= 1;
  }
  return true;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // bits left-aligned
  int nbits = 0;
  bool marker = false;

  BitReader(const uint8_t* begin, const uint8_t* stop) : p(begin), end(stop) {}

  void fill() {
    while (nbits <= 56) {
      uint64_t b = 0;
      if (!marker && p < end) {
        b = *p++;
        if (b == 0xFF) {
          if (p < end && *p == 0x00) {
            ++p;
          } else {
            marker = true;  // zero bits from here on
            b = 0;
          }
        }
      }
      buf |= b << (56 - nbits);
      nbits += 8;
    }
  }

  uint32_t get(int n) {  // n in 1..16
    if (nbits < n) fill();
    uint32_t v = static_cast<uint32_t>(buf >> (64 - n));
    buf <<= n;
    nbits -= n;
    return v;
  }

  int decode(const std::vector<uint16_t>& lut) {
    if (nbits < 16) fill();
    uint16_t e = lut[buf >> 48];
    int len = e >> 8;
    if (len == 0) return -1;
    buf <<= len;
    nbits -= len;
    return e & 0xFF;
  }

  int receive_extend(int s) {
    if (s == 0) return 0;
    int v = static_cast<int>(get(s));
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
};

}  // namespace

extern "C" {

// Decodes one scan. Returns 0, -1 on a bad Huffman code, -2 on a bad table,
// -3 on a bad argument.
//   data: the scan's entropy-coded bytes; seg_starts/seg_ends: byte offsets
//     of its n_segments restart segments (restart markers left out);
//   restart_interval: MCUs per segment (0: the scan is one segment);
//   n_comp: components in the scan; comp_h, comp_v: their sampling factors
//     (1, 1 for a one-component scan); blocks_w: each component's plane
//     width in blocks; coef: each component's plane, int16 blocks of 64;
//   dc_tab, ac_tab: each component's table slots (0-3);
//   huff_bits (8 x 17), huff_vals (8 x 256): slots 0-3 DC, 4-7 AC;
//     huff_bits[t][1..16] are the counts of codes of each length;
//   mcus_x, mcus_y: the scan's MCU grid.
int octseg_jpeg_decode_scan(const uint8_t* data, const int64_t* seg_starts,
                            const int64_t* seg_ends, int n_segments, int restart_interval,
                            int n_comp, const int* comp_h, const int* comp_v,
                            const int* blocks_w, int16_t** coef, const int* dc_tab,
                            const int* ac_tab, const uint8_t* huff_bits,
                            const uint8_t* huff_vals, int mcus_x, int mcus_y) {
  if (n_comp < 1 || n_comp > 4 || n_segments < 1) return -3;
  std::vector<uint16_t> dc[4], ac[4];
  for (int c = 0; c < n_comp; ++c) {
    if (dc_tab[c] < 0 || dc_tab[c] > 3 || ac_tab[c] < 0 || ac_tab[c] > 3) return -3;
    if (!build_table(huff_bits + 17 * dc_tab[c], huff_vals + 256 * dc_tab[c], &dc[c]))
      return -2;
    if (!build_table(huff_bits + 17 * (4 + ac_tab[c]), huff_vals + 256 * (4 + ac_tab[c]),
                     &ac[c]))
      return -2;
  }
  const int64_t total = static_cast<int64_t>(mcus_x) * mcus_y;
  const int64_t per_segment = restart_interval > 0 ? restart_interval : total;
  int64_t mcu = 0;
  for (int s = 0; s < n_segments && mcu < total; ++s) {
    BitReader br(data + seg_starts[s], data + seg_ends[s]);
    int pred[4] = {0, 0, 0, 0};
    for (int64_t m = 0; m < per_segment && mcu < total; ++m, ++mcu) {
      const int64_t my = mcu / mcus_x, mx = mcu % mcus_x;
      for (int c = 0; c < n_comp; ++c) {
        for (int by = 0; by < comp_v[c]; ++by) {
          for (int bx = 0; bx < comp_h[c]; ++bx) {
            const int64_t row = my * comp_v[c] + by, col = mx * comp_h[c] + bx;
            int16_t* block = coef[c] + (row * blocks_w[c] + col) * 64;
            std::memset(block, 0, 64 * sizeof(int16_t));
            int t = br.decode(dc[c]);
            if (t < 0 || t > 16) return -1;
            pred[c] += br.receive_extend(t);
            block[0] = static_cast<int16_t>(pred[c]);
            for (int k = 1; k < 64;) {
              int rs = br.decode(ac[c]);
              if (rs < 0) return -1;
              int r = rs >> 4, sz = rs & 15;
              if (sz == 0) {
                if (r != 15) break;  // end of block
                k += 16;
                continue;
              }
              k += r;
              int v = br.receive_extend(sz);
              if (k > 63) break;
              block[kZigzag[k]] = static_cast<int16_t>(v);
              ++k;
            }
          }
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
