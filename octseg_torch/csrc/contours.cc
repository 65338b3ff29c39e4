// Contours of a binary mask, on the host: the border follower that
// cv2.findContours runs (Suzuki and Abe, 1985, in OpenCV's formulation), in
// two retrieval modes and two approximations, with the same points in the
// same order as cv2 5.0:
//   - RETR_EXTERNAL: outer borders not inside another border;
//   - RETR_TREE: every outer and hole border, each with its parent;
//   - CHAIN_APPROX_SIMPLE: a point where the chain direction changes;
//   - CHAIN_APPROX_NONE: every pixel the follower steps on.
//
// octseg_torch/analyze/contours.py calls it and keeps its plain version,
// ``_find_contours_python``, beside it; the tests hold both to cv2.
//
// Semantics, as cv2:
//   - every nonzero pixel is foreground, connectivity 8; the mask is padded
//     with one zero pixel on each side, so a mask touching the image border
//     is traced like any other (points are given in the mask's coordinates);
//   - a raster scan (rows top down, columns left to right) starts an outer
//     border where a 0 is followed by an unvisited 1, and a hole border
//     where a pixel that is not marked negative is followed by a 0 (the
//     border then starts on that pixel); ``lnbd`` is the last border pixel
//     the scan passed on the row;
//   - RETR_EXTERNAL traces an outer border only if the pixel at ``lnbd`` is
//     not marked positive (a pixel of an enclosing border, not on its right
//     side), and no hole border;
//   - RETR_TREE traces every border; its parent comes from the border that
//     last marked the pixel at ``lnbd`` (none where ``lnbd`` is the padding):
//     that border itself when one is an outer border and the other a hole,
//     else that border's parent;
//   - an outer border is followed counterclockwise in image coordinates from
//     its first pixel with the search starting at direction 4, a hole border
//     from direction 0; the directions 0..7 are right, up-right, up,
//     up-left, left, down-left, down, down-right; a traced pixel takes the
//     border's label (2, 3, ... in the order found), or its negative where
//     the search passed its right neighbour as background; a lone pixel is
//     a one-point contour.
//
// The caller orders the contours: cv2 returns RETR_EXTERNAL's last found
// first, and RETR_TREE's as a depth-first walk whose children come last
// found first.
//
// Also here: cv2.approxPolyDP of integer contours, many at once (the
// analyze app reduces every contour of a frame), the plain version being
// octseg_torch/data/draw.py's ``approx_poly_dp``: Douglas-Peucker from two
// far points of a closed curve (from its ends for an open one) with
// distances to the segment, then the pass that drops points on almost
// straight lines.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 (octseg_torch/analyze/contours.py
// does it at first use). Plain C interface, loaded with ctypes.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

namespace {

const int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

// Follow the border that starts at (x0, y0) of the padded image, label it
// ``nbd`` and append its points (in mask coordinates) to ``pts``.
void trace(int32_t* img, int64_t step, int x0, int y0, bool hole, bool every_point,
           int32_t nbd, std::vector<int32_t>* pts) {
  int64_t delta[16];
  for (int k = 0; k < 8; ++k) delta[k] = delta[k + 8] = kDy[k] * step + kDx[k];
  int32_t* i0 = img + y0 * step + x0;
  const int s_start = hole ? 0 : 4;
  int s = s_start;
  int32_t* i1;
  do {
    s = (s - 1) & 7;
    i1 = i0 + delta[s];
  } while (*i1 == 0 && s != s_start);
  if (s == s_start) {   // a lone pixel
    *i0 = -nbd;
    pts->push_back(x0 - 1);
    pts->push_back(y0 - 1);
    return;
  }
  int32_t* i3 = i0;
  int32_t* i4;
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
      *i3 = -nbd;
    } else if (*i3 == 1) {
      *i3 = nbd;
    }
    if (s != prev_s || every_point) {
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

struct Pt {
  int32_t x, y;
  bool operator!=(const Pt& o) const { return x != o.x || y != o.y; }
};

// Squared distance of p to the segment a-b (d = b - a, len2 = |d|^2): its
// nearer end where it projects outside.
double segment_dist2(Pt p, Pt a, Pt b, double dx, double dy, double len2) {
  const double px = static_cast<double>(p.x - a.x), py = static_cast<double>(p.y - a.y);
  const double dot = px * dx + py * dy;
  if (dot <= 0) return px * px + py * py;
  if (dot >= len2) {
    const double ex = static_cast<double>(p.x - b.x), ey = static_cast<double>(p.y - b.y);
    return ex * ex + ey * ey;
  }
  const double cross = py * dx - px * dy;
  return cross * cross / len2;
}

// One contour: src (count points) -> dst, returns the number kept.
int64_t approx_one(const Pt* src, int64_t count, double epsilon, bool closed0, Pt* dst) {
  if (count == 0) return 0;
  const double eps = epsilon * epsilon;
  std::vector<std::pair<int64_t, int64_t>> stack;
  int64_t new_count = 0;
  bool is_closed = closed0;
  int init_iters = 3;
  int64_t slice_start = 0, slice_end = 0, right_start = 0, right_end = 0, pos = 0;
  Pt start_pt{-1000000, -1000000};
  auto next = [&count](int64_t p) { return p + 1 < count ? p + 1 : 0; };   // count shrinks below
  if (!is_closed) {
    right_start = count;
    const Pt end_pt = src[0];
    start_pt = src[count - 1];
    if (start_pt != end_pt) {
      slice_start = 0;
      slice_end = count - 1;
      stack.emplace_back(slice_start, slice_end);
    } else {
      is_closed = true;
      init_iters = 1;
    }
  }
  if (is_closed) {
    right_start = 0;
    bool le_eps = false;
    for (int it = 0; it < init_iters; ++it) {
      double max_dist = 0;
      pos = (pos + right_start) % count;
      start_pt = src[pos];
      pos = next(pos);
      for (int64_t j = 1; j < count; ++j) {
        const Pt pt = src[pos];
        pos = next(pos);
        const double dx = pt.x - start_pt.x, dy = pt.y - start_pt.y;
        const double dist = dx * dx + dy * dy;
        if (dist > max_dist) {
          max_dist = dist;
          right_start = j;
        }
      }
      le_eps = max_dist <= eps;
    }
    if (!le_eps) {
      right_end = slice_start = pos % count;
      slice_end = right_start = (right_start + slice_start) % count;
      stack.emplace_back(right_start, right_end);
      stack.emplace_back(slice_start, slice_end);
    } else {
      dst[new_count++] = start_pt;
    }
  }
  while (!stack.empty()) {
    slice_start = stack.back().first;
    slice_end = stack.back().second;
    stack.pop_back();
    const Pt end_pt = src[slice_end];
    pos = slice_start;
    start_pt = src[pos];
    pos = next(pos);
    bool le_eps;
    if (pos != slice_end) {
      double max_dist = 0;
      const double dx = end_pt.x - start_pt.x, dy = end_pt.y - start_pt.y;
      const double len2 = dx * dx + dy * dy;
      while (pos != slice_end) {
        const Pt pt = src[pos];
        pos = next(pos);
        const double dist = segment_dist2(pt, start_pt, end_pt, dx, dy, len2);
        if (dist > max_dist) {
          max_dist = dist;
          right_start = (pos + count - 1) % count;
        }
      }
      le_eps = max_dist <= eps;
    } else {
      le_eps = true;
      start_pt = src[slice_start];
    }
    if (le_eps) {
      dst[new_count++] = start_pt;
    } else {
      right_end = slice_end;
      slice_end = right_start;
      stack.emplace_back(right_start, right_end);
      stack.emplace_back(slice_start, slice_end);
    }
  }
  if (!is_closed) dst[new_count++] = src[count - 1];

  // drop extra points on [almost] straight lines
  is_closed = closed0;
  count = new_count;
  pos = is_closed ? count - 1 : 0;
  start_pt = dst[pos];
  pos = next(pos);
  int64_t wpos = pos;
  Pt pt = dst[pos];
  pos = next(pos);
  int64_t i = is_closed ? 0 : 1;
  while (i < count - (is_closed ? 0 : 1) && new_count > 2) {
    const Pt end_pt = dst[pos];
    pos = next(pos);
    const double dx = end_pt.x - start_pt.x, dy = end_pt.y - start_pt.y;
    const double dist = std::fabs((pt.x - start_pt.x) * dy - (pt.y - start_pt.y) * dx);
    const double inner = static_cast<double>(pt.x - start_pt.x) * (end_pt.x - pt.x) +
                         static_cast<double>(pt.y - start_pt.y) * (end_pt.y - pt.y);
    if (dist * dist <= 0.5 * eps * (dx * dx + dy * dy) && dx != 0 && dy != 0 && inner >= 0) {
      --new_count;
      dst[wpos] = start_pt = end_pt;
      wpos = next(wpos);
      pt = dst[pos];
      pos = next(pos);
      i += 2;
      continue;
    }
    dst[wpos] = start_pt = pt;
    wpos = next(wpos);
    pt = end_pt;
    ++i;
  }
  if (!is_closed) dst[wpos] = pt;
  return new_count;
}

}  // namespace

// Many contours at once: contour k is points[ends[k - 1]:ends[k]] ((x, y)
// int32 pairs, ends[-1] = 0). Writes each one's approximation into
// ``out_points`` (room for as many points as the input) and the index one
// past its last point into ``out_ends``.
extern "C" void octseg_approx_poly_dp(const int32_t* points, const int64_t* ends, int64_t n,
                                      double epsilon, int32_t closed, int32_t* out_points,
                                      int64_t* out_ends) {
  const Pt* src = reinterpret_cast<const Pt*>(points);
  Pt* dst = reinterpret_cast<Pt*>(out_points);
  int64_t start = 0, written = 0;
  for (int64_t k = 0; k < n; ++k) {
    written += approx_one(src + start, ends[k] - start, epsilon, closed != 0, dst + written);
    out_ends[k] = written;
    start = ends[k];
  }
}

// mask: (h, w) uint8, row-major, contiguous; nonzero is foreground.
// tree: 0 for RETR_EXTERNAL, 1 for RETR_TREE; every_point: 0 for
// CHAIN_APPROX_SIMPLE, 1 for CHAIN_APPROX_NONE.
// Writes the contours in the order found: their points as (x, y) int32
// pairs into ``points``, the index one past each contour's last point into
// ``ends``, and each contour's parent (its index in found order, -1 for
// none) into ``parents``. needed[0] and needed[1] receive the number of
// points and of contours. Returns the number of contours, or -1 when
// ``points_cap`` points or ``ends_cap`` contours do not hold them (nothing
// is written then; call again with larger buffers).
extern "C" int64_t octseg_find_contours(const uint8_t* mask, int32_t h, int32_t w,
                                        int32_t tree, int32_t every_point,
                                        int32_t* points, int64_t points_cap, int64_t* ends,
                                        int32_t* parents, int64_t ends_cap,
                                        int64_t* needed) {
  const int64_t step = static_cast<int64_t>(w) + 2;
  std::vector<int32_t> img(static_cast<size_t>(h + 2) * step, 0);
  for (int32_t y = 0; y < h; ++y) {
    const uint8_t* src = mask + static_cast<int64_t>(y) * w;
    int32_t* dst = img.data() + (y + 1) * step + 1;
    for (int32_t x = 0; x < w; ++x) dst[x] = src[x] != 0;
  }
  std::vector<int32_t> pts;
  std::vector<int64_t> contour_ends;
  std::vector<int32_t> contour_parents;
  std::vector<char> contour_holes;
  for (int y = 1; y <= h; ++y) {
    const int32_t* row = img.data() + y * step;
    int lnbd = 0;   // the last border pixel passed on this row (column 0: padding)
    int32_t prev = 0;
    for (int x = 1; x <= w; ++x) {
      const int32_t p = row[x];
      if (p == prev) continue;
      bool hole = false;
      bool start = prev == 0 && p == 1;
      if (!start && p == 0 && prev >= 1) {
        if (prev >= 2) lnbd = x - 1;   // the hole's first pixel is already a border pixel
        hole = true;
        start = true;
      }
      if (start && !tree && (hole || row[lnbd] > 0)) start = false;
      if (start) {
        int32_t parent = -1;
        if (tree && lnbd > 0) {
          const int32_t last = std::abs(row[lnbd]) - 2;
          parent = contour_holes[last] == static_cast<char>(hole) ? contour_parents[last] : last;
        }
        const int origin = x - hole;
        lnbd = origin;
        const int32_t nbd = static_cast<int32_t>(contour_ends.size()) + 2;
        trace(img.data(), step, origin, y, hole, every_point != 0, nbd, &pts);
        contour_ends.push_back(static_cast<int64_t>(pts.size() / 2));
        contour_parents.push_back(parent);
        contour_holes.push_back(static_cast<char>(hole));
        prev = row[x];
        continue;
      }
      prev = p;
      if (p != 0 && p != 1) lnbd = x;
    }
  }
  needed[0] = static_cast<int64_t>(pts.size() / 2);
  needed[1] = static_cast<int64_t>(contour_ends.size());
  if (needed[0] > points_cap || needed[1] > ends_cap) return -1;
  if (!pts.empty()) std::memcpy(points, pts.data(), pts.size() * sizeof(int32_t));
  if (!contour_ends.empty()) {
    std::memcpy(ends, contour_ends.data(), contour_ends.size() * sizeof(int64_t));
    std::memcpy(parents, contour_parents.data(), contour_parents.size() * sizeof(int32_t));
  }
  return needed[1];
}
