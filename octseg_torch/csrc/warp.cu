// Augmentation warp: images bilinear and masks nearest through per-sample
// 3x3 inverse homographies, zero border. CUDA C++ for sm_90a.
//
// Replaces TPU kernel K2, octseg/ops/pallas/resample.py (`_pass_call`, body
// `_make_kernel`, entry `warp_pair_2pass`). That kernel splits the warp
// into two 1-D passes of small matrix products only because per-index
// gathers are slow on the TPU; the function it stands for is the one its
// docstring names as its parity target, `_sample_pair_fused`
// (octseg/ops/warp.py), which octseg_torch/ops/warp.py `sample_pair_at`
// computes in plain torch. On the card a gather is cheap, so this kernel is
// that function directly.
//
// Per output pixel (x, y) of sample b, with m = mats[b] (row-major 3x3):
//   sx = (m0 x + m1 y + m2) / (m6 x + m7 y + m8),  sy likewise with m3..m5;
//   x0 = floor(sx), y0 = floor(sy), wx = sx - x0, wy = sy - y0;
//   if x0 or y0 lies outside [-1, size - 1]: every output channel is 0;
//   taps t00 (y0, x0), t01 (y0, x0+1), t10 (y0+1, x0), t11 (y0+1, x0+1),
//   each rounded to bfloat16, 0 outside the frame;
//   image channel: (t00 (1-wx) + t01 wx) (1-wy) + (t10 (1-wx) + t11 wx) wy;
//   mask channel: the tap (wy >= 0.5) * 2 + (wx >= 0.5).
// The coordinate and blend arithmetic uses __fmul_rn / __fadd_rn /
// __fdiv_rn in the plain version's order, so nvcc cannot contract a
// multiply-add and move a coordinate by an ulp: masks are bit-exact and
// images equal to the plain version. Each pixel's coordinates are computed
// from (x, y) on their own (m1 y, m4 y and m7 y are shared along the row:
// the same products), never stepped along the row, which would round
// differently.
//
// Bound: memory. Per output pixel the kernel reads at least the (Ci + Cm)
// float32 channels of about one source pixel and writes (Ci + Cm) float32
// channels: 56 B at 3 + 4 channels, against about 60 arithmetic operations,
// far below the card's float32 rate. Inputs and outputs are NHWC (the JAX
// layout).
//
// Design. Grid (column tiles of TILE pixels, rows, samples): no thread
// divides an index, and indices inside a sample are 32-bit. A block's
// THREADS threads walk the tile's row PX times, thread t taking pixels
// t, t + THREADS, ...: a warp's pixels are consecutive, and the matrix and
// the row's products are loaded once per thread. Image taps are gathered
// through the read-only path (__ldg). On the training path (3 image and 4
// mask channels, W % 4 == 0, 16 B aligned outputs and masks) a mask tap is
// one 16 B load and its output one 16 B store, and the image output goes
// through shared memory and leaves as coalesced 16 B stores. Other channel
// counts and unaligned shapes take the general path: scalar loops, direct
// stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int PX = 4;                 // pixels per thread
constexpr int TILE = THREADS * PX;    // pixels per block

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// (m0 x + m1y) + m2 with m1y = m1 y: each product and sum rounded on its own
__device__ __forceinline__ float affine_row(float m0, float m1y, float m2, float x) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m0, x), m1y), m2);
}

template <bool kFast>
__global__ void __launch_bounds__(THREADS)
warp_pair_kernel(const float* __restrict__ imgs, const float* __restrict__ masks,
                 const float* __restrict__ mats, float* __restrict__ img_out,
                 float* __restrict__ mask_out, int n, int h, int w, int ci, int cm) {
  __shared__ float4 stage[kFast ? TILE * 3 / 4 : 1];   // the tile's image output
  if (kFast) {
    ci = 3;
    cm = 4;
  }
  const int tx = threadIdx.x;
  const int xt = blockIdx.x * TILE;
  for (int b = blockIdx.z; b < n; b += gridDim.z) {
    float m[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) m[i] = __ldg(mats + 9 * b + i);
    const size_t plane = (size_t)b * h * w;
    const float* im = imgs + plane * ci;
    const float* mk = masks + plane * cm;
    float* io = img_out + plane * ci;
    float* mo = mask_out + plane * cm;

    for (int y = blockIdx.y; y < h; y += gridDim.y) {
      const float yf = (float)y;
      const float m1y = __fmul_rn(m[1], yf), m4y = __fmul_rn(m[4], yf),
                  m7y = __fmul_rn(m[7], yf);
#pragma unroll
      for (int p = 0; p < PX; ++p) {
        const int x = xt + p * THREADS + tx;
        if (x >= w) continue;
        const int q = y * w + x;   // output pixel inside the sample
        const float xf = (float)x;
        const float pw = affine_row(m[6], m7y, m[8], xf);
        const float sx = __fdiv_rn(affine_row(m[0], m1y, m[2], xf), pw);
        const float sy = __fdiv_rn(affine_row(m[3], m4y, m[5], xf), pw);
        const float fx0 = floorf(sx), fy0 = floorf(sy);
        // written so that a NaN coordinate is invalid too
        const bool valid = fx0 >= -1.f && fx0 <= (float)(w - 1) && fy0 >= -1.f &&
                           fy0 <= (float)(h - 1);
        float wx = 0.f, wy = 0.f, omx = 0.f, omy = 0.f;
        int x0 = 0, y0 = 0;
        if (valid) {
          wx = __fsub_rn(sx, fx0);
          wy = __fsub_rn(sy, fy0);
          omx = __fsub_rn(1.f, wx);
          omy = __fsub_rn(1.f, wy);
          x0 = (int)fx0;
          y0 = (int)fy0;
        }
        const bool in_x0 = valid && x0 >= 0, in_x1 = valid && x0 + 1 < w;
        const bool in_y0 = valid && y0 >= 0, in_y1 = valid && y0 + 1 < h;
        // pixel index of tap (0, 0), read only where a tap is in the frame
        const int p00 = y0 * w + x0;
        const int my = y0 + (wy >= 0.5f ? 1 : 0), mx = x0 + (wx >= 0.5f ? 1 : 0);
        const bool in_mask = valid && my >= 0 && my < h && mx >= 0 && mx < w;
        const int pm = my * w + mx;

        // on the fast path the image output goes to the stage, ci == 3
        float* dst = kFast ? reinterpret_cast<float*>(stage) + (p * THREADS + tx) * 3
                           : io + q * ci;
        for (int c = 0; c < ci; ++c) {
          const float t00 = (in_y0 && in_x0) ? bf16_round(__ldg(im + p00 * ci + c)) : 0.f;
          const float t01 = (in_y0 && in_x1) ? bf16_round(__ldg(im + (p00 + 1) * ci + c)) : 0.f;
          const float t10 = (in_y1 && in_x0) ? bf16_round(__ldg(im + (p00 + w) * ci + c)) : 0.f;
          const float t11 =
              (in_y1 && in_x1) ? bf16_round(__ldg(im + (p00 + w + 1) * ci + c)) : 0.f;
          const float top = __fadd_rn(__fmul_rn(t00, omx), __fmul_rn(t01, wx));
          const float bot = __fadd_rn(__fmul_rn(t10, omx), __fmul_rn(t11, wx));
          dst[c] = valid ? __fadd_rn(__fmul_rn(top, omy), __fmul_rn(bot, wy)) : 0.f;
        }
        if (kFast) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in_mask) {
            v = __ldg(reinterpret_cast<const float4*>(mk) + pm);
            v = make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z), bf16_round(v.w));
          }
          reinterpret_cast<float4*>(mo)[q] = v;
        } else {
          for (int c = 0; c < cm; ++c) {
            mo[q * cm + c] = in_mask ? bf16_round(__ldg(mk + pm * cm + c)) : 0.f;
          }
        }
      }
      if (kFast) {
        // the tile's image output: its pixel count is a multiple of 4 (W % 4
        // == 0), so it is a whole number of 16 B words, 16 B aligned
        __syncthreads();
        const int words = min(TILE, w - xt) * 3 / 4;
        float4* dst = reinterpret_cast<float4*>(io + (y * w + xt) * 3);
        for (int i = tx; i < words; i += THREADS) dst[i] = stage[i];
        __syncthreads();   // the next row reuses the stage
      }
    }
  }
}

}  // namespace

extern "C" int octseg_warp_pair(const float* imgs, const float* masks, const float* mats,
                                float* img_out, float* mask_out, int n, int h, int w,
                                int ci, int cm, void* stream) {
  if ((long long)n * h * w == 0) return 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(masks) | reinterpret_cast<uintptr_t>(mask_out) |
                         reinterpret_cast<uintptr_t>(img_out)) & 15) == 0;
  const bool fast = ci == 3 && cm == 4 && w % 4 == 0 && aligned;
  const dim3 grid((w + TILE - 1) / TILE, h < 65535 ? h : 65535, n < 65535 ? n : 65535);
  cudaStream_t s = (cudaStream_t)stream;
  if (fast) {
    warp_pair_kernel<true><<<grid, THREADS, 0, s>>>(imgs, masks, mats, img_out, mask_out,
                                                    n, h, w, ci, cm);
  } else {
    warp_pair_kernel<false><<<grid, THREADS, 0, s>>>(imgs, masks, mats, img_out, mask_out,
                                                     n, h, w, ci, cm);
  }
  return (int)cudaGetLastError();
}
