// Huffman entropy decoding of JPEG scans on the host: sequential (baseline
// SOF0 and extended SOF1), progressive (SOF2) and lossless (SOF3), 8-bit.
//
// octseg_torch/data/jpeg.py parses the markers, splits each scan's
// entropy-coded bytes at its restart markers and does everything after this
// stage (dequantization, IDCT, upsampling, colour conversion) in numpy. This
// file turns one scan into int16 coefficient blocks in natural (row-major)
// order (sequential and progressive scans) or into samples (lossless scans),
// exactly as data/jpeg.py's Python decoders do; those are its plain versions
// and the tests hold the two equal.
//
// Semantics, as libjpeg-turbo's decoders (jdhuff.c, jdphuff.c, jdlhuff.c,
// jddiffct.c, jdlossls.c):
//   - the bit stream of a restart segment is its bytes with each FF 00
//     replaced by FF; the first FF not followed by 00 ends the segment's
//     data (a marker or fill), and zero bits are read after it;
//   - DC predictions, a progressive scan's EOB run and a lossless scan's
//     predictor (back to the first row's) restart in every segment;
//   - a block of a component with sampling h x v sits at block row
//     mcu_y * v + by, block column mcu_x * h + bx of that component's plane
//     (the caller passes h = v = 1 for a scan of one component, whose MCU is
//     one block);
//   - a progressive scan adds to the coefficients earlier scans left: DC
//     first (the DC difference, shifted left by Al), DC refine (one bit),
//     AC first (band Ss..Se, with EOB runs) and AC refine (correction bits
//     for coefficients already nonzero, newly nonzero ones +-2^Al, zero
//     runs that skip nonzero coefficients).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 (octseg_torch/data/jpeg.py does it
// at first use). Plain C interface, loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag position -> natural index, with libjpeg's 16 guard entries: a
// corrupt run past 63 lands on 63
const int kZigzag[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

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

// Decodes one progressive scan into the coefficient planes, which hold what
// earlier scans left. Arguments as octseg_jpeg_decode_scan's, plus the
// scan's spectral band ss..se and successive-approximation bits ah, al (the
// caller has checked them as libjpeg does: a DC scan has se = 0, an AC scan
// one component). Returns 0, -1 on a bad Huffman code, -2 on a bad table,
// -3 on a bad argument.
int octseg_jpeg_decode_progressive_scan(const uint8_t* data, const int64_t* seg_starts,
                                        const int64_t* seg_ends, int n_segments,
                                        int restart_interval, int n_comp, const int* comp_h,
                                        const int* comp_v, const int* blocks_w, int16_t** coef,
                                        const int* dc_tab, const int* ac_tab,
                                        const uint8_t* huff_bits, const uint8_t* huff_vals,
                                        int mcus_x, int mcus_y, int ss, int se, int ah, int al) {
  if (n_comp < 1 || n_comp > 4 || n_segments < 1 || ss < 0 || se > 63 || ss > se) return -3;
  if (ss > 0 && n_comp != 1) return -3;
  std::vector<uint16_t> lut[4];
  for (int c = 0; c < n_comp; ++c) {
    if (ss == 0 && ah != 0) continue;  // DC refinement reads bare bits
    const int slot = ss == 0 ? dc_tab[c] : 4 + ac_tab[c];
    if (dc_tab[c] < 0 || dc_tab[c] > 3 || ac_tab[c] < 0 || ac_tab[c] > 3) return -3;
    if (!build_table(huff_bits + 17 * slot, huff_vals + 256 * slot, &lut[c])) return -2;
  }
  const int p1 = 1 << al;     // 1 in the bit position being coded
  const int m1 = -(1 << al);  // -1 in that position
  const int64_t total = static_cast<int64_t>(mcus_x) * mcus_y;
  const int64_t per_segment = restart_interval > 0 ? restart_interval : total;
  int64_t mcu = 0;
  for (int s = 0; s < n_segments && mcu < total; ++s) {
    BitReader br(data + seg_starts[s], data + seg_ends[s]);
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    for (int64_t m = 0; m < per_segment && mcu < total; ++m, ++mcu) {
      const int64_t my = mcu / mcus_x, mx = mcu % mcus_x;
      for (int c = 0; c < n_comp; ++c) {
        for (int by = 0; by < comp_v[c]; ++by) {
          for (int bx = 0; bx < comp_h[c]; ++bx) {
            const int64_t row = my * comp_v[c] + by, col = mx * comp_h[c] + bx;
            int16_t* block = coef[c] + (row * blocks_w[c] + col) * 64;
            if (ss == 0 && ah == 0) {  // DC first
              int t = br.decode(lut[c]);
              if (t < 0 || t > 16) return -1;
              pred[c] += br.receive_extend(t);
              block[0] = static_cast<int16_t>(static_cast<unsigned>(pred[c]) << al);
            } else if (ss == 0) {  // DC refine
              if (br.get(1)) block[0] = static_cast<int16_t>(block[0] | p1);
            } else if (ah == 0) {  // AC first
              if (eobrun > 0) {
                --eobrun;
                continue;
              }
              for (int k = ss; k <= se; ++k) {
                int rs = br.decode(lut[c]);
                if (rs < 0) return -1;
                int r = rs >> 4, sz = rs & 15;
                if (sz) {
                  k += r;
                  int v = br.receive_extend(sz);
                  block[kZigzag[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
                } else if (r == 15) {
                  k += 15;
                } else {
                  eobrun = 1 << r;
                  if (r) eobrun += static_cast<int>(br.get(r));
                  --eobrun;
                  break;
                }
              }
            } else {  // AC refine
              int k = ss;
              if (eobrun == 0) {
                for (; k <= se; ++k) {
                  int rs = br.decode(lut[c]);
                  if (rs < 0) return -1;
                  int r = rs >> 4, sz = rs & 15, v = 0;
                  if (sz) {
                    v = br.get(1) ? p1 : m1;  // a newly nonzero coefficient
                  } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += static_cast<int>(br.get(r));
                    break;
                  }
                  // skip r zero coefficients, correcting the nonzero ones met
                  do {
                    int16_t* z = block + kZigzag[k];
                    if (*z != 0) {
                      if (br.get(1) && (*z & p1) == 0)
                        *z = static_cast<int16_t>(*z + (*z >= 0 ? p1 : m1));
                    } else if (--r < 0) {
                      break;
                    }
                    ++k;
                  } while (k <= se);
                  if (v) block[kZigzag[k]] = static_cast<int16_t>(v);
                }
              }
              if (eobrun > 0) {
                // the band's rest: correction bits for the nonzero coefficients
                for (; k <= se; ++k) {
                  int16_t* z = block + kZigzag[k];
                  if (*z != 0 && br.get(1) && (*z & p1) == 0)
                    *z = static_cast<int16_t>(*z + (*z >= 0 ? p1 : m1));
                }
                --eobrun;
              }
            }
          }
        }
      }
    }
  }
  return 0;
}

// Decodes one lossless scan (every component sampled 1x1) into 8-bit
// samples. planes: each scan component's (height, width) uint8 plane;
// rows_per_segment: rows per restart segment (0: one segment); dc_tab: each
// component's table slot (0-3); predictor 1-7; pt: the point transform;
// precision: 2-8. A sample is the predictor plus the decoded difference
// modulo 2^16, shifted left by pt; the first row of a segment predicts
// 2^(precision - pt - 1) for its first sample and the left neighbour after
// it, every other row the sample above for its first. Returns 0, -1 on a
// bad Huffman code, -2 on a bad table, -3 on a bad argument.
int octseg_jpeg_decode_lossless_scan(const uint8_t* data, const int64_t* seg_starts,
                                     const int64_t* seg_ends, int n_segments,
                                     int rows_per_segment, int n_comp, int width, int height,
                                     uint8_t** planes, const int* dc_tab,
                                     const uint8_t* huff_bits, const uint8_t* huff_vals,
                                     int predictor, int pt, int precision) {
  if (n_comp < 1 || n_comp > 4 || n_segments < 1 || width < 1 || height < 1 ||
      predictor < 1 || predictor > 7 || pt < 0 || pt >= precision)
    return -3;
  std::vector<uint16_t> lut[4];
  for (int c = 0; c < n_comp; ++c) {
    if (dc_tab[c] < 0 || dc_tab[c] > 3) return -3;
    if (!build_table(huff_bits + 17 * dc_tab[c], huff_vals + 256 * dc_tab[c], &lut[c]))
      return -2;
  }
  const int rows = rows_per_segment > 0 ? rows_per_segment : height;
  const int initial = 1 << (precision - pt - 1);
  std::vector<int> diff(static_cast<size_t>(n_comp) * width);
  std::vector<int> prev(static_cast<size_t>(n_comp) * width), cur(prev.size());
  int y = 0;
  for (int s = 0; s < n_segments && y < height; ++s) {
    BitReader br(data + seg_starts[s], data + seg_ends[s]);
    for (int r = 0; r < rows && y < height; ++r, ++y) {
      for (int x = 0; x < width; ++x) {
        for (int c = 0; c < n_comp; ++c) {
          int t = br.decode(lut[c]);
          if (t < 0 || t > 16) return -1;
          diff[c * width + x] = t == 16 ? 32768 : br.receive_extend(t);
        }
      }
      for (int c = 0; c < n_comp; ++c) {
        const int* d = diff.data() + c * width;
        const int* up = prev.data() + c * width;
        int* out = cur.data() + c * width;
        if (r == 0) {  // the first row of a segment
          out[0] = (d[0] + initial) & 0xFFFF;
          for (int x = 1; x < width; ++x) out[x] = (d[x] + out[x - 1]) & 0xFFFF;
        } else {
          out[0] = (d[0] + up[0]) & 0xFFFF;
          for (int x = 1; x < width; ++x) {
            const int ra = out[x - 1], rb = up[x], rc = up[x - 1];
            int p = 0;
            switch (predictor) {
              case 1: p = ra; break;
              case 2: p = rb; break;
              case 3: p = rc; break;
              case 4: p = ra + rb - rc; break;
              case 5: p = ra + ((rb - rc) >> 1); break;
              case 6: p = rb + ((ra - rc) >> 1); break;
              default: p = (ra + rb) >> 1; break;
            }
            out[x] = (d[x] + p) & 0xFFFF;
          }
        }
        uint8_t* dst = planes[c] + static_cast<int64_t>(y) * width;
        for (int x = 0; x < width; ++x) dst[x] = static_cast<uint8_t>(out[x] << pt);
      }
      prev.swap(cur);
    }
  }
  return 0;
}

}  // extern "C"

