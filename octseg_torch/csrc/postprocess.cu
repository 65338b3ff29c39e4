// Fused overlay postprocess for a stack of binary masks, for sm_90a.
//
// Replaces the TPU kernel octseg/ops/pallas/postprocess.py
// (_fused_overlay_postprocess / _make_kernel). For masks m (M, H, W) float32
// in {0,1} it writes, in one pass:
//
//   closed = 1 - dilate5(1 - dilate5(m))     (5x5 ellipse; each intermediate
//                                             is masked to the image, which
//                                             gives cv2's border semantics)
//   ring   = dilate7(closed) * dilate7(1 - closed)   (7x7 ellipse)
//   fill   = GaussianBlur5(closed)           (separable, REFLECT_101 border)
//
// equal to the plain chain octseg_torch.ops.kernels.postprocess.postprocess_chain.
//
// Bound: memory. The kernel reads 4 B and writes 8 B per pixel. Masks are
// binary, so every stage works on 32-pixel words: bit i of word j of a row
// is pixel 32 j + i. One thread then handles 32 pixels of a stage, and the
// shared-memory traffic per pixel is a few bits instead of the 125 float
// loads of a tap-by-tap float design.
//
// Design. One block per (mask, strip of ROWS rows, CW words = 1024 columns);
// a 1000 px frame is one column tile. Shared memory holds the strip with a
// 7-row halo (the chain's reach, 2 + 2 + 3) and one halo word on each side.
//   load   each warp reads 32 consecutive floats (one 128 B load) and packs
//          them with __ballot_sync(v > 0.5); rows and words outside the frame
//          and bits past W are 0
//   S1     u      = ~dil5(m) & inside         rows +-5 around the strip
//   S2     closed = ~dil5(u) & inside, nc = ~closed & inside   rows +-3
//   S4     ring   = dil7(closed) & dil7(nc)   the strip's rows
//   patch  closed's bits at columns -2, -1, W, W+1 take the REFLECT_101
//          values of columns 2, 1, W-2, W-3 where the tile holds them
//          (ring has read closed already)
//   out    each lane expands 4 pixels: ring through a 16-entry float4 table;
//          fill = s / 256 with the integer sum
//          s = sum_dy [1 4 6 4 1]_dy h(reflect101(y + dy)),
//          h = [1 4 6 4 1] over the row's bits x-2..x+2, read from a
//          256-entry table indexed by the 8 bits x-2..x+5 (four pixels'
//          h values as 16-bit fields). The float chain's partial sums are
//          multiples of 1/256 of 0/1 values, exact in float32, so fill is
//          equal to it bit for bit. Stores are streaming (__stcs), 16 B where
//          W % 4 == 0 and the outputs are 16 B aligned, scalar elsewhere.
// A dilation is shift-and-OR: a row dilated by r pixels is the OR of the word
// funnel-shifted by 1..r either way, with the neighbouring words' carry bits
// (__funnelshift_l/_r). ELLIPSE_5 is rows |dy| <= 1 at +-2 px and rows
// |dy| = 2 at the centre (17 taps); ELLIPSE_7 rows |dy| <= 1 at +-3, |dy| = 2
// at +-2 and |dy| = 3 at the centre (33 taps).
// The halo words are computed as if their outer neighbour were 0: that
// spoils at most their 4 outer bits (reach 2 + 2), and the tile reads only
// their 3 inner bits (reach 3).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32;             // output rows per block
constexpr int HALO = 7;              // 2 + 2 + 3
constexpr int SR = ROWS + 2 * HALO;  // rows held in shared memory
constexpr int CW = 32;               // output words per block (1024 px)
constexpr int SW = CW + 2;           // words held: the tile and one each side
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

typedef uint32_t Rows[SW];

// the row word dilated by r pixels, with its neighbours' carry bits
template <int r>
__device__ __forceinline__ uint32_t hdil(uint32_t prev, uint32_t w, uint32_t next) {
  uint32_t v = w;
#pragma unroll
  for (int s = 1; s <= r; ++s) {
    v |= __funnelshift_l(prev, w, s) | __funnelshift_r(w, next, s);
  }
  return v;
}

template <int r>
__device__ __forceinline__ uint32_t hdil_at(const Rows* s, int row, int k) {
  return hdil<r>(k > 0 ? s[row][k - 1] : 0u, s[row][k], k < SW - 1 ? s[row][k + 1] : 0u);
}

__device__ __forceinline__ uint32_t dil5(const Rows* s, int r, int k) {
  return s[r - 2][k] | s[r + 2][k] | hdil_at<2>(s, r - 1, k) | hdil_at<2>(s, r, k) |
         hdil_at<2>(s, r + 1, k);
}

__device__ __forceinline__ uint32_t dil7(const Rows* s, int r, int k) {
  return s[r - 3][k] | s[r + 3][k] | hdil_at<2>(s, r - 2, k) | hdil_at<2>(s, r + 2, k) |
         hdil_at<3>(s, r - 1, k) | hdil_at<3>(s, r, k) | hdil_at<3>(s, r + 1, k);
}

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i > n - 1) i = 2 * (n - 1) - i;
  return i;
}

struct Tile {
  int y0, j0, H, W, nw;
  uint32_t last;   // valid bits of the frame's last word
  // bits of shared word (r, k) that lie inside the frame
  __device__ __forceinline__ uint32_t inside(int r, int k) const {
    const int gy = y0 - HALO + r, gj = j0 - 1 + k;
    if (gy < 0 || gy >= H || gj < 0 || gj >= nw) return 0u;
    return gj == nw - 1 ? last : FULL;
  }
  // shared word and bit of image column x (x may be -2 .. W + 1)
  __device__ __forceinline__ int word_of(int x) const { return (x >> 5) - j0 + 1; }
};

__device__ __forceinline__ uint32_t get_bit(const Rows* s, const Tile& t, int r, int x) {
  return (s[r][t.word_of(x)] >> (x & 31)) & 1u;
}

__device__ __forceinline__ void set_bit(Rows* s, const Tile& t, int r, int x, uint32_t b) {
  uint32_t& w = s[r][t.word_of(x)];
  w = (w & ~(1u << (x & 31))) | (b << (x & 31));
}

__global__ void __launch_bounds__(THREADS)
fused_overlay_postprocess_kernel(const float* __restrict__ in,
                                 float* __restrict__ fill,
                                 float* __restrict__ ring,
                                 int M, int H, int W, int vec) {
  __shared__ uint32_t sA[SR][SW];   // m, later nc
  __shared__ uint32_t sB[SR][SW];   // u, later ring
  __shared__ uint32_t sC[SR][SW];   // closed, patched for the blur
  __shared__ uint2 hlut[256];       // 8 bits x-2..x+5 -> h(x..x+3), 16 bits each
  __shared__ float4 rlut[16];       // 4 ring bits -> 4 floats

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Tile t;
  t.y0 = blockIdx.y * ROWS;
  t.j0 = blockIdx.x * CW;
  t.H = H;
  t.W = W;
  t.nw = (W + 31) >> 5;
  t.last = (W & 31) ? (1u << (W & 31)) - 1u : FULL;

  {
    const uint32_t b = tid;   // THREADS == 256 entries
    uint32_t h[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      h[p] = ((b >> p) & 1u) + 4u * ((b >> (p + 1)) & 1u) + 6u * ((b >> (p + 2)) & 1u) +
             4u * ((b >> (p + 3)) & 1u) + ((b >> (p + 4)) & 1u);
    }
    hlut[b] = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
    if (tid < 16) {
      rlut[tid] = make_float4((float)(tid & 1), (float)((tid >> 1) & 1),
                              (float)((tid >> 2) & 1), (float)((tid >> 3) & 1));
    }
  }
  __syncthreads();

  // the strip's output rows and words inside the frame
  const int out_rows = min(ROWS, H - t.y0);
  const int out_words = min(CW, t.nw - t.j0);

  for (int mask = blockIdx.z; mask < M; mask += gridDim.z) {
    const size_t base = (size_t)mask * H * W;

    // load: a warp packs one word per step, four loads in flight
    for (int item0 = warp; item0 < SR * SW; item0 += 4 * WARPS) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int item = item0 + u * WARPS;
        const int r = item / SW, k = item - r * SW;
        const int gy = t.y0 - HALO + r, gx = (t.j0 - 1 + k) * 32 + lane;
        v[u] = (item < SR * SW && gy >= 0 && gy < H && gx >= 0 && gx < W)
                   ? __ldg(in + base + (size_t)gy * W + gx) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int item = item0 + u * WARPS;
        const uint32_t bits = __ballot_sync(FULL, v[u] > 0.5f);
        if (lane == 0 && item < SR * SW) sA[item / SW][item % SW] = bits;
      }
    }
    __syncthreads();

    // S1: u = ~dil5(m) & inside
    for (int i = tid; i < (SR - 4) * SW; i += THREADS) {
      const int r = 2 + i / SW, k = i % SW;
      sB[r][k] = ~dil5(sA, r, k) & t.inside(r, k);
    }
    __syncthreads();

    // S2: closed = ~dil5(u) & inside; nc = ~closed & inside (m is dead)
    for (int i = tid; i < (SR - 8) * SW; i += THREADS) {
      const int r = 4 + i / SW, k = i % SW;
      const uint32_t in_ = t.inside(r, k);
      const uint32_t c = ~dil5(sB, r, k) & in_;
      sC[r][k] = c;
      sA[r][k] = ~c & in_;
    }
    __syncthreads();

    // S4: ring = dil7(closed) & dil7(nc) on the strip (u is dead)
    for (int i = tid; i < ROWS * CW; i += THREADS) {
      const int r = HALO + i / CW, k = 1 + i % CW;
      sB[r][k] = dil7(sC, r, k) & dil7(sA, r, k);
    }
    __syncthreads();

    // patch: REFLECT_101 columns for the blur, one thread per row read
    for (int r = HALO - 2 + tid; r < HALO + ROWS + 2; r += THREADS) {
      const int gy = t.y0 - HALO + r;
      if (gy < 0 || gy >= H) continue;
      if (t.j0 == 0) {
        set_bit(sC, t, r, -1, get_bit(sC, t, r, 1));
        set_bit(sC, t, r, -2, get_bit(sC, t, r, 2));
      }
      // columns W and W + 1 in the tile's words (the last one may be the
      // right halo word, read by the tile's last two pixels)
      if (((W + 1) >> 5) <= t.j0 + CW) {
        set_bit(sC, t, r, W, get_bit(sC, t, r, W - 2));
        set_bit(sC, t, r, W + 1, get_bit(sC, t, r, W - 3));
      }
    }
    __syncthreads();

    // out: a lane expands 4 pixels, a warp 128 (4 words) per step
    const int groups = (out_words + 3) >> 2;
    for (int item = warp; item < out_rows * groups; item += WARPS) {
      const int r = HALO + item / groups;
      const int k = 1 + 4 * (item % groups) + (lane >> 3);
      const int b = (lane & 7) * 4;
      const int gy = t.y0 - HALO + r;
      const int x = (t.j0 + k - 1) * 32 + b;
      if (k > out_words || x >= W) continue;
      const float4 rg = rlut[(sB[r][k] >> b) & 15u];
      uint2 acc = make_uint2(0u, 0u);
#pragma unroll
      for (int dy = -2; dy <= 2; ++dy) {
        const int rr = reflect101(gy + dy, H) - t.y0 + HALO;
        const uint32_t lo = b == 0 ? sC[rr][k - 1] : sC[rr][k];
        const uint32_t hi = b == 0 ? sC[rr][k] : sC[rr][k + 1];
        const uint2 h = hlut[__funnelshift_r(lo, hi, (b - 2) & 31) & 255u];
        const uint32_t wgt = (dy == 0) ? 6u : (dy == 1 || dy == -1) ? 4u : 1u;
        acc.x += wgt * h.x;
        acc.y += wgt * h.y;
      }
      const float s = 1.f / 256.f;
      const float4 f = make_float4((float)(acc.x & 0xffffu) * s, (float)(acc.x >> 16) * s,
                                   (float)(acc.y & 0xffffu) * s, (float)(acc.y >> 16) * s);
      const size_t o = base + (size_t)gy * W + x;
      if (vec) {
        __stcs(reinterpret_cast<float4*>(fill + o), f);
        __stcs(reinterpret_cast<float4*>(ring + o), rg);
      } else {
        const float fv[4] = {f.x, f.y, f.z, f.w};
        const float rv[4] = {rg.x, rg.y, rg.z, rg.w};
        const int n = min(4, W - x);
        for (int p = 0; p < n; ++p) {
          __stcs(fill + o + p, fv[p]);
          __stcs(ring + o + p, rv[p]);
        }
      }
    }
    __syncthreads();   // the next mask reuses the shared arrays
  }
}

}  // namespace

extern "C" int octseg_fused_overlay_postprocess(const float* in, float* fill,
                                                float* ring, int M, int H,
                                                int W, void* stream) {
  if (M <= 0 || H <= 0 || W <= 0) return 0;
  const int nw = (W + 31) / 32;
  const int vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(fill) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(ring) & 15) == 0;
  dim3 grid((nw + CW - 1) / CW, (H + ROWS - 1) / ROWS, M < 65535 ? M : 65535);
  fused_overlay_postprocess_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      in, fill, ring, M, H, W, vec);
  return (int)cudaGetLastError();
}
