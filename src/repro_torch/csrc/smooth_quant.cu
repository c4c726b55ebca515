// Fused per-token activation smoothing + symmetric int8 quantization
// (paper Eq. 9):  xs = X * s,  dx = max(rowmax|xs|, 1e-8) * f32(1/127),
//                 Xq = clip(round(xs / dx), -127, 127).
// (The reciprocal multiplication is what XLA makes of the reference's
// division by the constant 127 inside jit.)
//
// Replaces the Pallas TPU kernel repro/kernels/smooth_quant.py:_kernel
// (pallas_call at smooth_quant.py:49).
//
// Bound on the H100: bytes.  Each element is read once (2 B bf16 or 4 B f32)
// and written once as int8; one multiply, one abs-max and one divide per
// element are far below the card's arithmetic rate.
//
// Design: one block of 256 threads per row.  Pass 1 forms xs = x * s and
// reduces |xs| to the row maximum (warp shuffles, then shared memory).
// Pass 2 reads the row again — it is at most 48 KB and still in L2 — forms
// the same xs and writes the quantized values.  No staging buffer, so any K
// fits.  Every step is an IEEE round-to-nearest operation (__fmul_rn,
// __fdiv_rn) and rintf rounds half to even, as torch.round and jnp.round
// do, so Xq and dx are bit-identical to the plain PyTorch version
// (kernels/smooth_quant.py).  Build without --use_fast_math.
// Non-finite rows follow the plain version too: the max carries a NaN
// through (fmaxf would drop it), so a row holding a NaN gets dx = NaN and
// its NaN logits still trip the engine's non-finite check downstream; a
// NaN code becomes 0, as torch's float -> int8 cast gives.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// max that returns a NaN operand, as torch.amax and jnp.max do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
smooth_quant_kernel(const T* __restrict__ x, const float* __restrict__ s,
                    int8_t* __restrict__ q, float* __restrict__ dx, int K) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * K;
  int8_t* qr = q + row * K;

  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads)
    amax = nan_max(amax, fabsf(__fmul_rn(to_f32(xr[k]), s[k])));
  for (int o = 16; o > 0; o >>= 1)
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));

  __shared__ float warp_max[kThreads / 32];
  __shared__ float row_dx;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = nan_max(m, warp_max[w]);
    const float d = __fmul_rn(nan_max(m, 1e-8f), 1.0f / 127.0f);
    row_dx = d;
    dx[row] = d;
  }
  __syncthreads();

  const float d = row_dx;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float r = rintf(__fdiv_rn(__fmul_rn(to_f32(xr[k]), s[k]), d));
    qr[k] = isnan(r) ? int8_t(0) : static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
  }
}

}  // namespace

// x: (M, K) row-major, bf16 (x_is_bf16 != 0) or f32; s: (K,) f32;
// q: (M, K) int8; dx: (M,) f32.  Returns cudaGetLastError().
extern "C" int smooth_quant_launch(const void* x, int x_is_bf16, const float* s,
                                   int8_t* q, float* dx, int M, int K,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > 0) {
    if (x_is_bf16)
      smooth_quant_kernel<__nv_bfloat16><<<M, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), s, q, dx, K);
    else
      smooth_quant_kernel<float><<<M, kThreads, 0, st>>>(
          static_cast<const float*>(x), s, q, dx, K);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* smooth_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
