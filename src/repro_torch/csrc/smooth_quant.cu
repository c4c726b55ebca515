// Fused per-token activation smoothing + symmetric int8 quantization
// (paper Eq. 9):  xs = X * s,  dx = max(rowmax|xs|, 1e-8) * f32(1/127),
//                 Xq = clip(round(xs / dx), -127, 127)
// (smooth_quant), and the same after an RMSNorm, for each of the 1-3
// linears that read the norm (norm_smooth_quant):
//   y = bf16/f32( (x * (1 / sqrt(sum(x^2) * f32(1/D) + eps))) * scale ),
//   then the above for y and each smooth vector s_i.
// (The reciprocal multiplication by f32(1/127) is what XLA makes of the
// reference's division by the constant 127 inside jit.)
//
// Replaces the Pallas TPU kernel repro/kernels/smooth_quant.py:_kernel
// (pallas_call at smooth_quant.py:49); norm_smooth_quant also takes over the
// RMSNorm before it (repro/models/common.py rms_norm) on the card.
//
// Bound on the H100: bytes, and at decode latency.  Each element is read
// once (2 B bf16 or 4 B f32) and written once per linear as int8; a few
// multiplies, one abs-max and one divide per element are far below the
// card's arithmetic rate.  A decode call has tens of rows, so one launch and
// a few dependent block reductions (~microseconds) dominate.
//
// Design: one block of 256 threads per row.  The row is read from device
// memory once, in 16-byte vectors (8 bf16 or 4 f32 values, a "chunk") where
// D and the pointers allow it (else element by element, in the same
// order), and held in registers: thread t holds chunks t, t + 256, ...
// (up to CPT of them, a template parameter: 2, enough for a 4096-wide bf16
// row, or 8; smooth_quant alone also 16, for llama-3.2-vision's 28672-wide
// down projection).  No second read of the row, so one block per row moves the
// bound's bytes.
// norm_smooth_quant's sum of squares is taken in an order the kernel fixes,
// whatever the number of rows: each thread adds the squares of its chunks'
// elements in index order into one f32 partial; the 32 partials of a warp
// are summed by the shuffle tree xor 16, 8, 4, 2, 1 (every lane ends with
// the same bits); then every thread adds the 8 warps' sums in warp order.
// Every step is an IEEE round-to-nearest operation with no contraction into
// FMA (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn), so the plain version
// (kernels/smooth_quant.py norm_smooth_quant_ref, the same order with
// elementwise f32 adds) gives the same bits, and a row's bits do not depend
// on how many rows share the call.
// The quantization is the same IEEE steps in both entry points (rintf
// rounds half to even, as torch.round and jnp.round do), so Xq and dx are
// bit-identical to the plain version (kernels/smooth_quant.py).  Build
// without --use_fast_math.  Non-finite rows follow the plain version too:
// the max carries a NaN through (fmaxf would drop it), so a row holding a
// NaN gets dx = NaN and its NaN logits still trip the engine's non-finite
// check downstream; a NaN code becomes 0, as torch's float -> int8 cast
// gives.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxNormCpt = 8;  // chunks a thread holds: D <= 8 * 256 * chunk (norm)
constexpr int kMaxCpt = 16;     // and without the norm: D <= 16 * 256 * chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// max that returns a NaN operand, as torch.amax and jnp.max do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// C floats of `p` at chunk k0 (C consecutive elements), zero past D.
template <int C>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, int k0, int D, bool vec,
                                         float (&v)[C]) {
  if (vec && k0 < D) {
#pragma unroll
    for (int i = 0; i < C; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + k0 + i);
      v[i] = f.x, v[i + 1] = f.y, v[i + 2] = f.z, v[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = k0 + i < D ? p[k0 + i] : 0.f;
  }
}

template <typename T, int C>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int k0, int D, bool vec,
                                         float (&v)[C]) {
  static_assert(C * sizeof(T) == 16, "a chunk is one 16-byte vector");
  if (vec && k0 < D) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + k0);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = k0 + i < D ? to_f32(p[k0 + i]) : 0.f;
  }
}

struct Targets {       // up to three linears reading the same row
  const float* s[3];   // smooth vectors (D,)
  int8_t* q[3];        // codes (M, D)
  float* dx[3];        // scales (M,)
};

// One row per block: [RMSNorm ->] for each of NS smooth vectors, smoothing,
// the row's abs-max, dx and the int8 codes.
template <typename T, bool NORM, int NS, int CPT>
__global__ void __launch_bounds__(kThreads)
quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale, float eps,
                  float inv_d, Targets tg, int D, int vec) {
  constexpr int C = 16 / sizeof(T);
  const int64_t row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ float red[NS][kWarps];

  float v[CPT][C];
#pragma unroll
  for (int i = 0; i < CPT; ++i)
    load_row<T, C>(x + row * D, (i * kThreads + threadIdx.x) * C, D, vec, v[i]);

  if (NORM) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i)
#pragma unroll
      for (int e = 0; e < C; ++e) part = __fadd_rn(part, __fmul_rn(v[i][e], v[i][e]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
    if (lane == 0) red[0][warp] = part;
    __syncthreads();
    float total = red[0][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total = __fadd_rn(total, red[0][w]);
    const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fmul_rn(total, inv_d), eps)));
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      float sc[C];
      const int k0 = (i * kThreads + threadIdx.x) * C;
      load_f32<C>(scale, k0, D, vec, sc);
#pragma unroll
      for (int e = 0; e < C; ++e)
        v[i][e] = round_to(__fmul_rn(__fmul_rn(v[i][e], inv), sc[e]), T());
    }
    __syncthreads();  // red is reused below
  }

  float amax[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) amax[n] = 0.f;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int k0 = (i * kThreads + threadIdx.x) * C;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float s[C];
      load_f32<C>(tg.s[n], k0, D, vec, s);
#pragma unroll
      for (int e = 0; e < C; ++e) amax[n] = nan_max(amax[n], fabsf(__fmul_rn(v[i][e], s[e])));
    }
  }
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax[n] = nan_max(amax[n], __shfl_xor_sync(0xffffffffu, amax[n], o));
    if (lane == 0) red[n][warp] = amax[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    float m = red[n][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = nan_max(m, red[n][w]);
    const float d = __fmul_rn(nan_max(m, 1e-8f), 1.0f / 127.0f);
    if (threadIdx.x == 0) tg.dx[n][row] = d;
    int8_t* qr = tg.q[n] + row * D;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int k0 = (i * kThreads + threadIdx.x) * C;
      if (k0 >= D) continue;
      float s[C];
      load_f32<C>(tg.s[n], k0, D, vec, s);
      union {
        int8_t b[C];
        typename std::conditional<C == 8, uint2, uint32_t>::type w;
      } out;
#pragma unroll
      for (int e = 0; e < C; ++e) {
        const float r = rintf(__fdiv_rn(__fmul_rn(v[i][e], s[e]), d));
        out.b[e] = isnan(r) ? int8_t(0) : static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
      }
      if (vec) {
        *reinterpret_cast<decltype(out.w)*>(qr + k0) = out.w;
      } else {
#pragma unroll
        for (int e = 0; e < C; ++e)
          if (k0 + e < D) qr[k0 + e] = out.b[e];
      }
    }
  }
}

template <typename T, bool NORM, int NS>
cudaError_t launch_cpt(int cpt, const T* x, const float* scale, float eps, float inv_d,
                       const Targets& tg, int M, int D, int vec, cudaStream_t st) {
#define QUANT_ROWS(N)                                                                  \
  if (cpt <= N) {                                                                      \
    quant_rows_kernel<T, NORM, NS, N><<<M, kThreads, 0, st>>>(x, scale, eps, inv_d, tg, \
                                                             D, vec);                  \
    return cudaSuccess;                                                                \
  }
  QUANT_ROWS(2)
  QUANT_ROWS(8)
  if constexpr (!NORM) {
    QUANT_ROWS(16)
  }
#undef QUANT_ROWS
  return cudaErrorInvalidValue;
}

template <bool NORM, int NS>
cudaError_t launch_rows(const void* x, int x_is_bf16, const float* scale, float eps,
                        float inv_d, const Targets& tg, int M, int D, cudaStream_t st) {
  const int C = x_is_bf16 ? 8 : 4;
  const int cpt = ((D + C - 1) / C + kThreads - 1) / kThreads;
  if (D <= 0 || cpt > (NORM ? kMaxNormCpt : kMaxCpt)) return cudaErrorInvalidValue;
  // 16-byte vectors where every chunk starts 16-byte aligned, in x and in the
  // f32 vectors (an 8-wide chunk spans two float4), and the codes' stores
  // (C bytes) are aligned
  bool vec = D % C == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
             (scale == nullptr || reinterpret_cast<uintptr_t>(scale) % 16 == 0);
  for (int n = 0; n < NS; ++n)
    vec = vec && reinterpret_cast<uintptr_t>(tg.s[n]) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(tg.q[n]) % C == 0;
  if (x_is_bf16)
    return launch_cpt<__nv_bfloat16, NORM, NS>(cpt, static_cast<const __nv_bfloat16*>(x),
                                               scale, eps, inv_d, tg, M, D, vec, st);
  return launch_cpt<float, NORM, NS>(cpt, static_cast<const float*>(x), scale, eps, inv_d,
                                     tg, M, D, vec, st);
}

}  // namespace

// x: (M, K) row-major, bf16 (x_is_bf16 != 0) or f32; s: (K,) f32;
// q: (M, K) int8; dx: (M,) f32.  K <= 16 * 256 * (8 bf16 or 4 f32).
// Returns the launch's error or cudaGetLastError().
extern "C" int smooth_quant_launch(const void* x, int x_is_bf16, const float* s,
                                   int8_t* q, float* dx, int M, int K, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > 0) {
    const Targets tg{{s, nullptr, nullptr}, {q, nullptr, nullptr}, {dx, nullptr, nullptr}};
    const cudaError_t e =
        launch_rows<false, 1>(x, x_is_bf16, nullptr, 0.f, 0.f, tg, M, K, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (M, D) row-major, bf16 (x_is_bf16 != 0) or f32; scale: (D,) f32 (the
// RMSNorm's); eps and inv_d = f32(1/D) as the plain version takes them; ns in
// 1..3 linears, each with its smooth vector s_i (D,) f32 and outputs q_i
// (M, D) int8 and dx_i (M,) f32 (unused pointers may be null).
// D <= 8 * 256 * (8 bf16 or 4 f32).  Returns the launch's error or
// cudaGetLastError().
extern "C" int norm_smooth_quant_launch(const void* x, int x_is_bf16, const float* scale,
                                        float eps, float inv_d, int ns, const float* s0,
                                        const float* s1, const float* s2, int8_t* q0,
                                        int8_t* q1, int8_t* q2, float* dx0, float* dx1,
                                        float* dx2, int M, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > 0) {
    const Targets tg{{s0, s1, s2}, {q0, q1, q2}, {dx0, dx1, dx2}};
    cudaError_t e = cudaErrorInvalidValue;
    if (ns == 1) e = launch_rows<true, 1>(x, x_is_bf16, scale, eps, inv_d, tg, M, D, st);
    if (ns == 2) e = launch_rows<true, 2>(x, x_is_bf16, scale, eps, inv_d, tg, M, D, st);
    if (ns == 3) e = launch_rows<true, 3>(x, x_is_bf16, scale, eps, inv_d, tg, M, D, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* smooth_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
