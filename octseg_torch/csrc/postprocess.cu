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
// Bound: memory. The kernel reads 4 B and writes 8 B per pixel; it does
// about 120 flops per pixel, far under the fp32 rate for that traffic. Each
// mask value is read from device memory once per tile (plus an 8-pixel halo)
// and every intermediate lives in shared memory only.
//
// Design (simple first): one block per (mask, 32x32 output tile). The tile
// and an 8-pixel halo (the chain's reach is 2 + 2 + 3 = 7) are loaded into
// shared memory, zero outside the image. Each stage is a loop over the
// shrinking valid region, separated by __syncthreads():
//   S1  u      = inside ? 1 - dilate5(m) : 0       on the region less 2
//   S2  closed = inside ? 1 - dilate5(u) : 0       on the region less 4
//   S3  nc     = inside ? 1 - closed : 0
//   S4  ring   = dilate7(closed) * dilate7(nc)     on the tile
//   S5  vertical blur of closed (reflected rows) on tile rows, cols +-2
//   S6  horizontal blur (reflected cols) -> fill   on the tile
// Dilations are maxima over the ellipse taps (17 for 5x5, 33 for 7x7).
// The blur's partial sums are multiples of 1/256 of 0/1 values, exact in
// float32, so fill is bit-exact with any summation order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 8;
constexpr int R = TILE + 2 * HALO;   // 48: the tile plus its halo
constexpr int LD = R + 1;            // padded row stride in shared memory
constexpr int THREADS = 256;

// Taps of cv2's elliptical structuring elements, as conditions on the
// unrolled offsets so that they resolve at compile time:
// ELLIPSE_5: rows |dy| <= 1 full, rows |dy| = 2 centre only (17 taps);
// ELLIPSE_7: rows |dy| <= 1 full, |dy| = 2 |dx| <= 2, |dy| = 3 centre (33).
__host__ __device__ constexpr bool in_e5(int dy, int dx) {
  return (dy >= -1 && dy <= 1) || dx == 0;
}
__host__ __device__ constexpr bool in_e7(int dy, int dx) {
  return (dy >= -1 && dy <= 1) || ((dy == 2 || dy == -2) && dx >= -2 && dx <= 2)
         || dx == 0;
}

__device__ __forceinline__ float dilate5(const float (*s)[LD], int y, int x) {
  float v = 0.f;
#pragma unroll
  for (int dy = -2; dy <= 2; ++dy) {
#pragma unroll
    for (int dx = -2; dx <= 2; ++dx) {
      if (in_e5(dy, dx)) v = fmaxf(v, s[y + dy][x + dx]);
    }
  }
  return v;
}

__device__ __forceinline__ float dilate7(const float (*s)[LD], int y, int x) {
  float v = 0.f;
#pragma unroll
  for (int dy = -3; dy <= 3; ++dy) {
#pragma unroll
    for (int dx = -3; dx <= 3; ++dx) {
      if (in_e7(dy, dx)) v = fmaxf(v, s[y + dy][x + dx]);
    }
  }
  return v;
}

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i > n - 1) i = 2 * (n - 1) - i;
  return i;
}

__global__ void __launch_bounds__(THREADS)
fused_overlay_postprocess_kernel(const float* __restrict__ in,
                                 float* __restrict__ fill,
                                 float* __restrict__ ring,
                                 int M, int H, int W) {
  __shared__ float sA[R][LD];   // m, later the vertical blur
  __shared__ float sB[R][LD];   // u, later nc
  __shared__ float sC[R][LD];   // closed

  const float g[5] = {0.0625f, 0.25f, 0.375f, 0.25f, 0.0625f};
  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * TILE - HALO;   // image row of local row 0
  const int c0 = blockIdx.x * TILE - HALO;   // image col of local col 0

  for (int mask = blockIdx.z; mask < M; mask += gridDim.z) {
    const size_t base = (size_t)mask * H * W;

    for (int i = tid; i < R * R; i += THREADS) {
      int y = i / R, x = i % R, gy = r0 + y, gx = c0 + x;
      bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      sA[y][x] = inside ? in[base + (size_t)gy * W + gx] : 0.f;
    }
    __syncthreads();

    // S1: u = (1 - dilate5(m)) masked to the image
    for (int i = tid; i < (R - 4) * (R - 4); i += THREADS) {
      int y = 2 + i / (R - 4), x = 2 + i % (R - 4), gy = r0 + y, gx = c0 + x;
      bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      sB[y][x] = inside ? 1.f - dilate5(sA, y, x) : 0.f;
    }
    __syncthreads();

    // S2: closed = (1 - dilate5(u)) masked to the image
    for (int i = tid; i < (R - 8) * (R - 8); i += THREADS) {
      int y = 4 + i / (R - 8), x = 4 + i % (R - 8), gy = r0 + y, gx = c0 + x;
      bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      sC[y][x] = inside ? 1.f - dilate5(sB, y, x) : 0.f;
    }
    __syncthreads();

    // S3: nc = (1 - closed) masked to the image (sB's u is no longer read)
    for (int i = tid; i < (R - 8) * (R - 8); i += THREADS) {
      int y = 4 + i / (R - 8), x = 4 + i % (R - 8), gy = r0 + y, gx = c0 + x;
      bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      sB[y][x] = inside ? 1.f - sC[y][x] : 0.f;
    }
    // S5 (before the barrier: it reads only sC and writes sA, whose m is
    // no longer read): vertical blur on the tile's rows, columns +-2
    for (int i = tid; i < TILE * (TILE + 4); i += THREADS) {
      int y = HALO + i / (TILE + 4), x = HALO - 2 + i % (TILE + 4);
      int gy = r0 + y, gx = c0 + x;
      float v = 0.f;
      if (gy < H && gx >= 0 && gx < W) {
#pragma unroll
        for (int k = -2; k <= 2; ++k) {
          v += g[k + 2] * sC[reflect101(gy + k, H) - r0][x];
        }
      }
      sA[y][x] = v;
    }
    __syncthreads();

    // S4 + S6: ring and fill on the tile; one row of 32 threads per row
    for (int i = tid; i < TILE * TILE; i += THREADS) {
      int y = HALO + i / TILE, x = HALO + i % TILE, gy = r0 + y, gx = c0 + x;
      if (gy < H && gx < W) {
        float rg = dilate7(sC, y, x) * dilate7(sB, y, x);
        float f = 0.f;
#pragma unroll
        for (int k = -2; k <= 2; ++k) {
          f += g[k + 2] * sA[y][reflect101(gx + k, W) - c0];
        }
        size_t o = base + (size_t)gy * W + gx;
        ring[o] = rg;
        fill[o] = f;
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
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, M < 65535 ? M : 65535);
  fused_overlay_postprocess_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      in, fill, ring, M, H, W);
  return (int)cudaGetLastError();
}
