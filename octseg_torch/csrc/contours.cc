// External contours of a binary mask, on the host: the border follower that
// cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE) runs (Suzuki
// and Abe, 1985, in OpenCV's formulation), with the same points in the same
// order.
//
// octseg_torch/analyze/contours.py calls it and keeps its plain version,
// ``_find_external_contours_python``, beside it; the tests hold both to cv2.
//
// Semantics, as cv2:
//   - every nonzero pixel is foreground, connectivity 8; the mask is padded
//     with one zero pixel on each side, so a mask touching the image border
//     is traced like any other (points are given in the mask's coordinates);
//   - a raster scan (rows top down, columns left to right) starts an outer
//     border where a 0 is followed by an unvisited 1, and traces it only if
//     the last border pixel the scan passed on that row is not marked
//     positive (a pixel of an enclosing border, not on its right side):
//     that is how RETR_EXTERNAL skips holes and what lies inside them;
//   - a border is followed counterclockwise in image coordinates, starting
//     down its left side; the directions 0..7 are right, up-right, up,
//     up-left, left, down-left, down, down-right; a traced pixel becomes 2,
//     or -126 where the search passed its right neighbour as background;
//   - CHAIN_APPROX_SIMPLE keeps a point where the chain direction changes;
//     a lone pixel is a one-point contour.
//
// The caller reverses the order of the contours: cv2 returns them last
// found first.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 (octseg_torch/analyze/contours.py
// does it at first use). Plain C interface, loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
constexpr int8_t kMark = 2;
constexpr int8_t kMarkRight = -126;   // 2 | -128

// Follow the outer border that starts at (x0, y0) of the padded image and
// append its CHAIN_APPROX_SIMPLE points (in mask coordinates) to ``pts``.
void trace(int8_t* img, int64_t step, int x0, int y0, std::vector<int32_t>* pts) {
  int64_t delta[16];
  for (int k = 0; k < 8; ++k) delta[k] = delta[k + 8] = kDy[k] * step + kDx[k];
  int8_t* i0 = img + y0 * step + x0;
  int s = 4;
  const int s_start = 4;
  int8_t* i1;
  do {
    s = (s - 1) & 7;
    i1 = i0 + delta[s];
  } while (*i1 == 0 && s != s_start);
  if (s == s_start) {   // a lone pixel
    *i0 = kMarkRight;
    pts->push_back(x0 - 1);
    pts->push_back(y0 - 1);
    return;
  }
  int8_t* i3 = i0;
  int8_t* i4;
  int prev_s = s ^ 4;
  int x = x0, y = y0;
  for (;;) {
    const int s_end = s;
    // the search ends by s_end + 8 at the latest: the pixel it came from
    do {
      i4 = i3 + delta[++s];
    } while (*i4 == 0);
    s &= 7;
    if (static_cast<unsigned>(s - 1) < static_cast<unsigned>(s_end)) {
      *i3 = kMarkRight;
    } else if (*i3 == 1) {
      *i3 = kMark;
    }
    if (s != prev_s) {
      pts->push_back(x - 1);
      pts->push_back(y - 1);
      prev_s = s;
    }
    x += kDx[s];
    y += kDy[s];
    if (i4 == i0 && i3 == i1) break;
    i3 = i4;
    s = (s + 4) & 7;
  }
}

}  // namespace

// mask: (h, w) uint8, row-major, contiguous; nonzero is foreground.
// Writes the contours in the order found: their points as (x, y) int32
// pairs into ``points`` and the index one past each contour's last point
// into ``ends``. needed[0] and needed[1] receive the number of points and of
// contours. Returns the number of contours, or -1 when ``points_cap`` points
// or ``ends_cap`` contours do not hold them (nothing is written then; call
// again with larger buffers).
extern "C" int64_t octseg_find_external_contours(const uint8_t* mask, int32_t h, int32_t w,
                                                  int32_t* points, int64_t points_cap,
                                                  int64_t* ends, int64_t ends_cap,
                                                  int64_t* needed) {
  const int64_t step = static_cast<int64_t>(w) + 2;
  std::vector<int8_t> img(static_cast<size_t>(h + 2) * step, 0);
  for (int32_t y = 0; y < h; ++y) {
    const uint8_t* src = mask + static_cast<int64_t>(y) * w;
    int8_t* dst = img.data() + (y + 1) * step + 1;
    for (int32_t x = 0; x < w; ++x) dst[x] = src[x] != 0;
  }
  std::vector<int32_t> pts;
  std::vector<int64_t> contour_ends;
  for (int y = 1; y <= h; ++y) {
    const int8_t* row = img.data() + y * step;
    int lnbd = 0;   // the last border pixel passed on this row (column 0: padding)
    int prev = 0;
    for (int x = 1; x <= w; ++x) {
      const int p = row[x];
      if (p == prev) continue;
      if (prev == 0 && p == 1) {
        if (row[lnbd] <= 0) {   // not inside an enclosing border
          lnbd = x;
          trace(img.data(), step, x, y, &pts);
          contour_ends.push_back(static_cast<int64_t>(pts.size() / 2));
          prev = row[x];
          continue;
        }
      } else if (p == 0 && prev >= 1 && (prev & -2)) {
        lnbd = x - 1;   // a hole starts after a traced pixel: it is the last border
      }
      prev = p;
      if (p & -2) lnbd = x;
    }
  }
  needed[0] = static_cast<int64_t>(pts.size() / 2);
  needed[1] = static_cast<int64_t>(contour_ends.size());
  if (needed[0] > points_cap || needed[1] > ends_cap) return -1;
  if (!pts.empty()) std::memcpy(points, pts.data(), pts.size() * sizeof(int32_t));
  if (!contour_ends.empty()) {
    std::memcpy(ends, contour_ends.data(), contour_ends.size() * sizeof(int64_t));
  }
  return needed[1];
}
