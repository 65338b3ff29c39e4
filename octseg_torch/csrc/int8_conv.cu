// int8 x int8 -> int32 convolution, dequantized per output channel (K4).
// CUDA C++ for sm_90a.
//
// Replaces no Pallas kernel: octseg leaves the convolution of its int8 path
// to XLA, `lax.conv_general_dilated(xq, wq, ..., preferred_element_type=
// int32)` in octseg/ops/quantize.py `quantized_conv` (:79-87), and its
// epilogue (:88-93) to XLA's fusion:
//   y[b, n, oy, ox] = float32(acc) * scale[n] (+ bias[n]), cast to the output type
// with scale[n] = (sa * sw[n]) / 16129 computed by the wrapper.
//
// Implicit GEMM, no im2col buffer: M = B * Ho * Wo output pixels, N = Cout,
// K = kh * kw * Cp ordered (ky, kx, ci), from
//   x: int8 NHWC (B, H, W, Cp), Cp % 8 == 0 (the activation kernel pads);
//   w: int8 (Cout, kh, kw, Cp), i.e. (N, K) with K contiguous;
// and written as float32 or bfloat16 NCHW (B, Cout, Ho, Wo). Stride,
// dilation and padding (asymmetric allowed: top and left are given, bottom
// and right follow from Ho and Wo) are predicates on the gather: a tap
// outside the frame reads zeros, which is what a zero input quantizes to.
// Tails of M, N and K are masked the same way.
//
// Design. A block of 256 threads (8 warps, 4 along M by 2 along N) computes
// a 128 x 64 tile of (pixels, channels) in steps of 64 along K. Each step's
// A and B tiles are copied into shared memory by cp.async, 16 B (Cp % 16 ==
// 0) or 8 B per copy, zero-filled where the predicate is off, three steps in
// flight. Rows are 80 B apart in shared memory, so the fragment loads of a
// warp hit 32 distinct banks. Each warp multiplies 32 x 32 with
// mma.sync.aligned.m16n8k32 (s8 x s8 -> s32), accumulators in registers.
// The epilogue converts with __int2float_rn and scales with __fmul_rn and
// __fadd_rn, so nvcc does not contract a multiply-add into an FMA, and
// rounds to bfloat16 with __float2bfloat16_rn: the output is bit-exact with
// the plain version. Integer sums are exact in any order, so the result is
// the same from run to run.
//
// Bound: the tensor cores for the large convolutions (2 M N K operations at
// 1,979 TOPS on an H100 SXM), memory for the small-M ones (the 1x1 maps of
// squeeze-excite convolutions, where M is the batch). A simple kernel:
// wgmma, TMA and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 64, BK = 64;
constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int LDS = BK + 16;   // bytes between rows of a tile in shared memory

struct Geometry {
  int h, w, cp, ho, wo, kh, kw, sh, sw, dh, dw, pt, pl, n, m, k;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool on) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(VEC), "r"(on ? VEC : 0));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int VEC, typename OutT>
__global__ void __launch_bounds__(THREADS)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 OutT* __restrict__ out, Geometry g) {
  constexpr int CPR = BK / VEC;              // copies per tile row
  constexpr int RSTEP = THREADS / CPR;       // rows between a thread's copies
  constexpr int A_ROWS = BM / RSTEP, B_ROWS = BN / RSTEP;
  __shared__ __align__(16) int8_t As[STAGES][BM * LDS];
  __shared__ __align__(16) int8_t Bs[STAGES][BN * LDS];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kc = tid % CPR, r0 = tid / CPR;
  const int hwo = g.ho * g.wo;

  // the output pixels of this thread's A rows: frame base, top-left tap
  long long a_base[A_ROWS];
  int a_iy[A_ROWS], a_ix[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int m = m0 + r0 + i * RSTEP;
    if (m < g.m) {
      const int b = m / hwo, p = m - b * hwo;
      const int oy = p / g.wo, ox = p - oy * g.wo;
      a_base[i] = (long long)b * g.h * g.w;
      a_iy[i] = oy * g.sh - g.pt;
      a_ix[i] = ox * g.sw - g.pl;
    } else {
      a_base[i] = 0;
      a_iy[i] = -(1 << 30);   // never inside the frame
      a_ix[i] = 0;
    }
  }

  auto load_tile = [&](int stage, int kt) {
    const int k = kt * BK + kc * VEC;
    const bool k_in = k < g.k;
    const int tap = k_in ? k / g.cp : 0;
    const int ci = k - tap * g.cp;
    const int ky = tap / g.kw, kx = tap - ky * g.kw;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const int iy = a_iy[i] + ky * g.dh, ix = a_ix[i] + kx * g.dw;
      const bool on = k_in && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
      const int8_t* src = on ? x + (a_base[i] + (long long)iy * g.w + ix) * g.cp + ci : x;
      cp_async<VEC>(&As[stage][(r0 + i * RSTEP) * LDS + kc * VEC], src, on);
    }
#pragma unroll
    for (int i = 0; i < B_ROWS; ++i) {
      const int n = n0 + r0 + i * RSTEP;
      const bool on = k_in && n < g.n;
      const int8_t* src = on ? wt + (long long)n * g.k + k : wt;
      cp_async<VEC>(&Bs[stage][(r0 + i * RSTEP) * LDS + kc * VEC], src, on);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  const int gr = lane >> 2, tq = lane & 3;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int kt_count = (g.k + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_count) load_tile(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < kt_count; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < kt_count) load_tile(next % STAGES, next);
    asm volatile("cp.async.commit_group;\n" ::);

    const int8_t* as = As[kt % STAGES];
    const int8_t* bs = Bs[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* base = as + (wm + i * 16 + gr) * LDS + kk + tq * 4;
        af[i][0] = *reinterpret_cast<const unsigned*>(base);
        af[i][1] = *reinterpret_cast<const unsigned*>(base + 8 * LDS);
        af[i][2] = *reinterpret_cast<const unsigned*>(base + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(base + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* base = bs + (wn + j * 8 + gr) * LDS + kk + tq * 4;
        bf[j][0] = *reinterpret_cast<const unsigned*>(base);
        bf[j][1] = *reinterpret_cast<const unsigned*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // epilogue: accumulator r of tile (i, j) is row gr + 8 * (r >= 2), column
  // 2 tq + (r & 1) of that 16 x 8 tile
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + gr + half * 8;
      if (m >= g.m) continue;
      const int b = m / hwo, p = m - b * hwo;
      OutT* row = out + (long long)b * g.n * hwo + p;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + tq * 2 + e;
          if (n >= g.n) continue;
          float v = __fmul_rn(__int2float_rn(acc[i][j][half * 2 + e]), scale[n]);
          if (bias != nullptr) v = __fadd_rn(v, bias[n]);
          store(row + (long long)n * hwo, v);
        }
      }
    }
  }
}

template <int VEC>
int launch_vec(const int8_t* x, const int8_t* w, const float* scale, const float* bias,
               void* out, int bf16, const Geometry& g, cudaStream_t s) {
  const dim3 grid((g.m + BM - 1) / BM, (g.n + BN - 1) / BN);
  if (bf16) {
    int8_conv_kernel<VEC, __nv_bfloat16><<<grid, THREADS, 0, s>>>(
        x, w, scale, bias, static_cast<__nv_bfloat16*>(out), g);
  } else {
    int8_conv_kernel<VEC, float><<<grid, THREADS, 0, s>>>(x, w, scale, bias,
                                                           static_cast<float*>(out), g);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (b, h, w, cp) int8; wt: (n, kh, kw, cp) int8; scale: (n,) float32; bias:
// (n,) float32 or null; out: (b, n, ho, wo) float32 (bf16 == 0) or bfloat16.
// Returns a CUDA error code, 0 on success; 1 (cudaErrorInvalidValue) for a
// channel count that is not a multiple of 8.
extern "C" int octseg_int8_conv(const void* x, const void* wt, const void* scale,
                                const void* bias, void* out, int bf16, int b, int h, int w,
                                int cp, int n, int kh, int kw, int ho, int wo, int sh, int sw,
                                int dh, int dw, int pt, int pl, void* stream) {
  Geometry g{h, w, cp, ho, wo, kh, kw, sh, sw, dh, dw, pt, pl, n, b * ho * wo, kh * kw * cp};
  if (g.m == 0 || n == 0) return 0;
  if (cp % 8 != 0) return (int)cudaErrorInvalidValue;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wt);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t s = (cudaStream_t)stream;
  if (cp % 16 == 0) return launch_vec<16>(xp, wp, sp, bp, out, bf16, g, s);
  return launch_vec<8>(xp, wp, sp, bp, out, bf16, g, s);
}
