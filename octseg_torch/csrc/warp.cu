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
// that function directly: one thread per output pixel, all channels.
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
// images equal to the plain version.
//
// Bound: memory. Per output pixel the kernel reads at least the (Ci + Cm)
// float32 channels of about one source pixel (each source pixel is read
// about once at scales near 1) and writes (Ci + Cm) float32 channels: 56 B
// at 3 + 4 channels, against about 60 arithmetic operations, far below the
// card's float32 rate. Inputs and outputs are NHWC (the JAX layout), so a
// pixel's channels are contiguous; neighbouring threads take neighbouring
// output pixels, whose taps are neighbouring source pixels for the
// near-identity maps of the augmentation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// m0 x + m1 y + m2, each product and sum rounded on its own
__device__ __forceinline__ float affine_row(const float* m, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m[0], x), __fmul_rn(m[1], y)), m[2]);
}

__global__ void warp_pair_kernel(const float* __restrict__ imgs,
                                 const float* __restrict__ masks,
                                 const float* __restrict__ mats,
                                 float* __restrict__ img_out,
                                 float* __restrict__ mask_out,
                                 int n, int h, int w, int ci, int cm) {
  const long long total = (long long)n * h * w;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int x = (int)(idx % w);
  const long long row = idx / w;
  const int y = (int)(row % h);
  const int b = (int)(row / h);

  const float* m = mats + 9LL * b;
  const float xf = (float)x, yf = (float)y;
  const float pw = affine_row(m + 6, xf, yf);
  const float sx = __fdiv_rn(affine_row(m, xf, yf), pw);
  const float sy = __fdiv_rn(affine_row(m + 3, xf, yf), pw);
  const float fx0 = floorf(sx), fy0 = floorf(sy);

  float* io = img_out + idx * ci;
  float* mo = mask_out + idx * cm;
  // written so that a NaN coordinate is invalid too
  const bool valid = fx0 >= -1.f && fx0 <= (float)(w - 1) && fy0 >= -1.f &&
                     fy0 <= (float)(h - 1);
  if (!valid) {
    for (int c = 0; c < ci; ++c) io[c] = 0.f;
    for (int c = 0; c < cm; ++c) mo[c] = 0.f;
    return;
  }
  const float wx = __fsub_rn(sx, fx0), wy = __fsub_rn(sy, fy0);
  const float omx = __fsub_rn(1.f, wx), omy = __fsub_rn(1.f, wy);
  const int x0 = (int)fx0, y0 = (int)fy0;
  const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < w;
  const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < h;
  const long long base = (long long)b * h * w;
  // pixel index of tap (dy, dx), valid only where that tap is in the frame
  const long long p00 = base + (long long)y0 * w + x0;

  for (int c = 0; c < ci; ++c) {
    const float t00 = (in_y0 && in_x0) ? bf16_round(imgs[p00 * ci + c]) : 0.f;
    const float t01 = (in_y0 && in_x1) ? bf16_round(imgs[(p00 + 1) * ci + c]) : 0.f;
    const float t10 = (in_y1 && in_x0) ? bf16_round(imgs[(p00 + w) * ci + c]) : 0.f;
    const float t11 = (in_y1 && in_x1) ? bf16_round(imgs[(p00 + w + 1) * ci + c]) : 0.f;
    const float top = __fadd_rn(__fmul_rn(t00, omx), __fmul_rn(t01, wx));
    const float bot = __fadd_rn(__fmul_rn(t10, omx), __fmul_rn(t11, wx));
    io[c] = __fadd_rn(__fmul_rn(top, omy), __fmul_rn(bot, wy));
  }

  const int dy = wy >= 0.5f ? 1 : 0, dx = wx >= 0.5f ? 1 : 0;
  const int my = y0 + dy, mx = x0 + dx;
  const bool in_mask = my >= 0 && my < h && mx >= 0 && mx < w;
  const long long pm = base + (long long)my * w + mx;
  for (int c = 0; c < cm; ++c) {
    mo[c] = in_mask ? bf16_round(masks[pm * cm + c]) : 0.f;
  }
}

}  // namespace

extern "C" int octseg_warp_pair(const float* imgs, const float* masks, const float* mats,
                                float* img_out, float* mask_out, int n, int h, int w,
                                int ci, int cm, void* stream) {
  const long long total = (long long)n * h * w;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  warp_pair_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
      imgs, masks, mats, img_out, mask_out, n, h, w, ci, cm);
  return (int)cudaGetLastError();
}
