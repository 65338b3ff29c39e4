// Activation quantization for the int8 convolutions (K5). CUDA C++ for sm_90a.
//
// Replaces no Pallas kernel: octseg leaves this to XLA's fusion of
// octseg/ops/quantize.py `quantized_conv` (:59-62), per tensor:
//   sa = max(max |x| as float32, 1e-8)
//   xq = clip(round_half_even(float32(x) * (127 / sa)), -127, 127) as int8
// with 127 / sa one float32 division before the multiply. Here the input is
// one float32 or bfloat16 NCHW tensor (B, C, H, W); the outputs are int8
// NHWC (B, H, W, Cp), channels C..Cp-1 zero (the convolution kernel reads
// whole 8-byte channel groups), and sa as a float32 scalar on the device:
// nothing is read back to the host.
//
// Pass 1 (`amax_kernel`): each thread takes the largest |x| of a grid-stride
// run as the unsigned bit pattern of the float (non-negative floats order as
// their bits, and a NaN's bits exceed infinity's, so a NaN wins as in
// jnp.max), a warp and then the block reduce it, and one atomicMax per block
// folds it into a word the wrapper zeroed.
// Pass 2 (`quantize_kernel`): each thread computes sa and 127 / sa from that
// word (__fdiv_rn, then __fmul_rn and rintf: nvcc contracts nothing), and a
// 32 x 32 tile of (channels, pixels) goes through shared memory so that the
// NCHW reads and the NHWC writes are both along consecutive addresses.
// Block (0, 0, 0) writes sa.
//
// Bound: memory. 4 B (2 B in bf16) are read twice and 1 B written per
// value; the arithmetic is a handful of operations per value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int AMAX_THREADS = 256;
constexpr int TILE = 32;
constexpr int ROWS = 8;   // threadIdx.y of the transpose block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(AMAX_THREADS)
amax_kernel(const T* __restrict__ x, long long n, unsigned int* __restrict__ bits) {
  unsigned int m = 0u;
  for (long long i = blockIdx.x * (long long)AMAX_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * AMAX_THREADS) {
    m = max(m, __float_as_uint(fabsf(to_float(x[i]))));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned int warp_max[AMAX_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < AMAX_THREADS / 32 ? warp_max[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) atomicMax(bits, m);
  }
}

template <typename T>
__global__ void __launch_bounds__(TILE * ROWS)
quantize_kernel(const T* __restrict__ x, const unsigned int* __restrict__ bits,
                int8_t* __restrict__ out, float* __restrict__ sa_out, int c, int cp, int hw) {
  __shared__ int8_t tile[TILE][TILE + 4];
  const float raw = __uint_as_float(*bits);
  const float sa = raw < 1e-8f ? 1e-8f : raw;   // a NaN stays NaN, as in jnp.maximum
  const float inv = __fdiv_rn(127.f, sa);
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0 &&
      threadIdx.y == 0) {
    *sa_out = sa;
  }
  const int p0 = blockIdx.x * TILE, c0 = blockIdx.y * TILE;
  const long long b = blockIdx.z;
  // read: thread (tx, ty) takes pixel p0 + tx of channels c0 + ty, + ROWS, ...
  for (int r = threadIdx.y; r < TILE; r += ROWS) {
    const int ch = c0 + r, p = p0 + threadIdx.x;
    int8_t q = 0;
    if (ch < c && p < hw) {
      const float v = to_float(x[(b * c + ch) * hw + p]);
      const float s = rintf(__fmul_rn(v, inv));
      q = (int8_t)(int)fminf(fmaxf(s, -127.f), 127.f);
    }
    tile[r][threadIdx.x] = q;
  }
  __syncthreads();
  // write: thread (tx, ty) takes channel c0 + tx of pixels p0 + ty, + ROWS, ...
  for (int r = threadIdx.y; r < TILE; r += ROWS) {
    const int p = p0 + r, ch = c0 + threadIdx.x;
    if (p < hw && ch < cp) out[(b * hw + p) * cp + ch] = tile[threadIdx.x][r];
  }
}

template <typename T>
int launch(const T* x, int8_t* out, unsigned int* bits, float* sa, int b, int c, int cp,
           int hw, cudaStream_t s) {
  const long long n = (long long)b * c * hw;
  long long blocks = (n + AMAX_THREADS - 1) / AMAX_THREADS;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) blocks = 1;
  amax_kernel<T><<<(int)blocks, AMAX_THREADS, 0, s>>>(x, n, bits);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const dim3 grid((hw + TILE - 1) / TILE, (cp + TILE - 1) / TILE, b);
  quantize_kernel<T><<<grid, dim3(TILE, ROWS), 0, s>>>(x, bits, out, sa, c, cp, hw);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (b, c, hw) float32 (bf16 == 0) or bfloat16 (bf16 == 1); out: (b, hw, cp)
// int8; bits: one zeroed 32-bit word; sa: one float32.
extern "C" int octseg_quantize_activation(const void* x, int bf16, void* out, void* bits,
                                          void* sa, int b, int c, int cp, int hw,
                                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    return launch(static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(out),
                  static_cast<unsigned int*>(bits), static_cast<float*>(sa), b, c, cp, hw, s);
  }
  return launch(static_cast<const float*>(x), static_cast<int8_t*>(out),
                static_cast<unsigned int*>(bits), static_cast<float*>(sa), b, c, cp, hw, s);
}
