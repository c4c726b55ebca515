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
// (up to CPT of them, a template parameter: smooth_quant 2, 8 or 16, for
// llama-3.2-vision's 28672-wide down projection; norm_smooth_quant 2, 4
// or 8).  No second read of the row, so one block per row moves the bound's
// bytes.
// norm_smooth_quant (norm_quant_kernel) at decode's tens of rows is bound
// by the latency of dependent steps, not by bytes: its first fused body
// loaded x, reduced, then loaded the norm's scale, then each reader's
// smooth vector, reduced again and loaded the smooth vectors a second time
// for the codes, three round trips to memory and three barriers for
// ~0.3 MB at (24, 4096, 3 readers).  This body issues every load that does
// not wait on a reduction when the block starts: x and the scale into
// registers, each reader's smooth vector into shared memory with cp.async
// (each thread copies the chunks it alone reads back, so no barrier guards
// them); it reduces the sum of squares, then takes every reader's abs-max
// in one block reduction (max is exact in any order) and reads the smooth
// vectors from shared memory for the codes: one round trip, two barriers.
// A trace of its blocks (%globaltimer per phase, H100) then showed the
// codes at ~1.1 us per reader: each value's division, rounding and
// conversion queued on the SM's 16-lane unit behind a branch per value.
// codes() below takes them on the FMA and integer pipes, a chunk at a time.
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

// max that gives the canonical NaN if either operand is a NaN (max.NaN):
// nan_max's bits for the operands the norm's abs-max sees (never -0; a NaN
// computed on the card is canonical), in one instruction.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// clip(round(a[e] / d), -127, 127) for a chunk of N values, as
// quant_rows_kernel takes them (half to even), for a finite d > 0 (the
// caller gives a row whose d is inf or NaN codes of 0, as the division
// does), from
// rinv = RN(1/d) on the FMA and integer pipes alone — no conversion (F2I,
// FRND) or division on the SM's 16-lane unit, no branch per value, so the
// values' dependent steps interleave: y = a * rinv lies within
// |a/d| * 1.5 * 2^-23 < 2^-15 of RN(a / d), since |a| <= the row's abs-max
// gives |a/d| <= 127.01, so where y is more than 0.0005 from a
// half-integer both round to the same integer; y + 1.5 * 2^23 rounds y half
// to even (|y| < 2^22) and holds the integer in its low bits.  A chunk with
// a value nearer a half-integer (rare) takes the exact divisions.
constexpr float kRound = 12582912.f;  // 1.5 * 2^23
template <int N>
__device__ __forceinline__ void codes(const float (&a)[N], float d, float rinv, int (&k)[N]) {
  bool exact = false;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float y = __fmul_rn(a[e], rinv), t = __fadd_rn(y, kRound);
    k[e] = __float_as_int(t) - __float_as_int(kRound);
    exact |= fabsf(__fsub_rn(y, __fsub_rn(t, kRound))) > 0.4995f;
  }
  if (exact) {
#pragma unroll
    for (int e = 0; e < N; ++e) k[e] = static_cast<int>(rintf(__fdiv_rn(a[e], d)));
  }
#pragma unroll
  for (int e = 0; e < N; ++e) k[e] = min(max(k[e], -127), 127);
}

// One row per block (smooth_quant): smoothing, the row's abs-max, dx and
// the int8 codes.
template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ smooth,
                  int8_t* __restrict__ q, float* __restrict__ dx, int D, int vec) {
  constexpr int C = 16 / sizeof(T);
  const int64_t row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __shared__ float red[kWarps];

  float v[CPT][C];
#pragma unroll
  for (int i = 0; i < CPT; ++i)
    load_row<T, C>(x + row * D, (i * kThreads + threadIdx.x) * C, D, vec, v[i]);

  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    float s[C];
    load_f32<C>(smooth, (i * kThreads + threadIdx.x) * C, D, vec, s);
#pragma unroll
    for (int e = 0; e < C; ++e) amax = nan_max(amax, fabsf(__fmul_rn(v[i][e], s[e])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = nan_max(m, red[w]);
  const float d = __fmul_rn(nan_max(m, 1e-8f), 1.0f / 127.0f);
  if (threadIdx.x == 0) dx[row] = d;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int k0 = (i * kThreads + threadIdx.x) * C;
    if (k0 >= D) continue;
    float s[C];
    load_f32<C>(smooth, k0, D, vec, s);
    union {
      int8_t b[C];
      typename std::conditional<C == 8, uint2, uint32_t>::type w;
    } out;
#pragma unroll
    for (int e = 0; e < C; ++e) {
      const float r = rintf(__fdiv_rn(__fmul_rn(v[i][e], s[e]), d));
      out.b[e] = isnan(r) ? int8_t(0) : static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
    }
    int8_t* qr = q + row * D;
    if (vec) {
      *reinterpret_cast<decltype(out.w)*>(qr + k0) = out.w;
    } else {
#pragma unroll
      for (int e = 0; e < C; ++e)
        if (k0 + e < D) qr[k0 + e] = out.b[e];
    }
  }
}

// Async 16- and 4-byte copies to shared memory; pred false reads nothing
// and zero-fills the destination.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(pred ? 4 : 0) : "memory");
}

// One row per block (norm_smooth_quant): the RMSNorm, then for each of NS
// smooth vectors smoothing, the row's abs-max, dx and the int8 codes.
// Dynamic shared memory: the NS smooth vectors, [NS][D rounded up to C],
// read back in 16-byte vectors (scalar reads of a chunk 32 bytes from the
// next thread's would take 8-way bank conflicts; a layout of consecutive
// 16-byte pieces per warp reads without any, but made the copies' issue
// three times slower on the H100).
template <typename T, int NS, int CPT>
__global__ void __launch_bounds__(kThreads)
norm_quant_kernel(const T* __restrict__ x, const float* __restrict__ scale, float eps,
                  float inv_d, Targets tg, int D, int vec) {
  constexpr int C = 16 / sizeof(T);
  const int64_t row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Dp = (D + C - 1) / C * C;
  extern __shared__ __align__(16) float s_sm[];
  __shared__ float red_sum[kWarps], red_max[NS][kWarps];
  // values 4q .. 4q + 3 of this thread's chunk i of smooth vector n
  auto smooth4 = [&](int n, int i, int q) {
    return s_sm + n * Dp + (i * kThreads + threadIdx.x) * C + 4 * q;
  };

  // every load that waits on no reduction, issued at once: this thread's
  // chunks of each smooth vector into shared memory (this thread alone
  // reads them back, after its own wait), of x and of the scale into
  // registers
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int k0 = (i * kThreads + threadIdx.x) * C;
    if (k0 >= D) continue;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        float* dst = smooth4(n, i, q);
        const int k = k0 + 4 * q;
        if (vec) {
          cp_async16(dst, tg.s[n] + k);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) cp_async4(dst + e, tg.s[n] + min(k + e, D - 1), k + e < D);
        }
      }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  float v[CPT][C], sc[CPT][C];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int k0 = (i * kThreads + threadIdx.x) * C;
    load_row<T, C>(x + row * D, k0, D, vec, v[i]);
    load_f32<C>(scale, k0, D, vec, sc[i]);
  }

  // the sum of squares in the order row_sum_squares fixes
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int e = 0; e < C; ++e) part = __fadd_rn(part, __fmul_rn(v[i][e], v[i][e]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, o));
  if (lane == 0) red_sum[warp] = part;
  __syncthreads();
  float total = red_sum[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) total = __fadd_rn(total, red_sum[w]);
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fmul_rn(total, inv_d), eps)));

  // y, and every reader's abs-max in one block reduction (chunks past D
  // add nothing: y and s are 0 there, and a NaN inv comes from a NaN row)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  float amax[NS][2];  // two per reader, so the max chains interleave
#pragma unroll
  for (int n = 0; n < NS; ++n) amax[n][0] = amax[n][1] = 0.f;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int k0 = (i * kThreads + threadIdx.x) * C;
#pragma unroll
    for (int e = 0; e < C; ++e) v[i][e] = round_to(__fmul_rn(__fmul_rn(v[i][e], inv), sc[i][e]), T());
    if (k0 >= D) continue;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float4 s = *reinterpret_cast<const float4*>(smooth4(n, i, q));
        amax[n][0] = max_nan(amax[n][0], fabsf(__fmul_rn(v[i][4 * q], s.x)));
        amax[n][1] = max_nan(amax[n][1], fabsf(__fmul_rn(v[i][4 * q + 1], s.y)));
        amax[n][0] = max_nan(amax[n][0], fabsf(__fmul_rn(v[i][4 * q + 2], s.z)));
        amax[n][1] = max_nan(amax[n][1], fabsf(__fmul_rn(v[i][4 * q + 3], s.w)));
      }
  }
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    float m = max_nan(amax[n][0], amax[n][1]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) red_max[n][warp] = m;
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    float m = red_max[n][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = max_nan(m, red_max[n][w]);
    const float d = __fmul_rn(nan_max(m, 1e-8f), 1.0f / 127.0f), rinv = __frcp_rn(d);
    const bool finite = d < INFINITY;  // else every a / d is NaN or 0: codes 0
    if (threadIdx.x == 0) tg.dx[n][row] = d;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int k0 = (i * kThreads + threadIdx.x) * C;
      if (k0 >= D) continue;
      union {
        int8_t b[C];
        typename std::conditional<C == 8, uint2, uint32_t>::type w;
      } out;
      float a[C];
#pragma unroll
      for (int q = 0; q < C / 4; ++q) {
        const float4 f = *reinterpret_cast<const float4*>(smooth4(n, i, q));
        a[4 * q] = __fmul_rn(v[i][4 * q], f.x);
        a[4 * q + 1] = __fmul_rn(v[i][4 * q + 1], f.y);
        a[4 * q + 2] = __fmul_rn(v[i][4 * q + 2], f.z);
        a[4 * q + 3] = __fmul_rn(v[i][4 * q + 3], f.w);
      }
      int k[C];
      codes<C>(a, d, rinv, k);
#pragma unroll
      for (int e = 0; e < C; ++e) out.b[e] = finite ? static_cast<int8_t>(k[e]) : int8_t(0);
      int8_t* qr = tg.q[n] + row * D;
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

// 16-byte vectors where every chunk starts 16-byte aligned, in x and in the
// f32 vectors (an 8-wide chunk spans two float4), and the codes' stores
// (C bytes) are aligned.
inline bool vectors_ok(const void* x, int C, int D, const float* scale, const Targets& tg,
                       int ns) {
  bool vec = D % C == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
             (scale == nullptr || reinterpret_cast<uintptr_t>(scale) % 16 == 0);
  for (int n = 0; n < ns; ++n)
    vec = vec && reinterpret_cast<uintptr_t>(tg.s[n]) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(tg.q[n]) % C == 0;
  return vec;
}

template <typename T>
cudaError_t launch_quant(const T* x, const Targets& tg, int M, int D, cudaStream_t st) {
  constexpr int C = 16 / sizeof(T);
  const int cpt = ((D + C - 1) / C + kThreads - 1) / kThreads;
  const int vec = vectors_ok(x, C, D, nullptr, tg, 1);
#define QUANT_ROWS(N)                                                                      \
  if (cpt <= N) {                                                                          \
    quant_rows_kernel<T, N><<<M, kThreads, 0, st>>>(x, tg.s[0], tg.q[0], tg.dx[0], D, vec); \
    return cudaSuccess;                                                                    \
  }
  QUANT_ROWS(2)
  QUANT_ROWS(8)
  QUANT_ROWS(16)
#undef QUANT_ROWS
  return cudaErrorInvalidValue;
}

template <typename T, int NS>
cudaError_t launch_norm(const T* x, const float* scale, float eps, float inv_d,
                        const Targets& tg, int M, int D, cudaStream_t st) {
  constexpr int C = 16 / sizeof(T);
  const int cpt = ((D + C - 1) / C + kThreads - 1) / kThreads;
  const int vec = vectors_ok(x, C, D, scale, tg, NS);
  const int smem = NS * ((D + C - 1) / C * C) * static_cast<int>(sizeof(float));
#define NORM_ROWS(N)                                                                       \
  if (cpt <= N) {                                                                          \
    auto kern = norm_quant_kernel<T, NS, N>;                                               \
    if (smem + 1024 > 48 * 1024) { /* the static bytes count against the 48 KB too */    \
      const cudaError_t e =                                                                \
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);   \
      if (e != cudaSuccess) return e;                                                      \
    }                                                                                      \
    kern<<<M, kThreads, smem, st>>>(x, scale, eps, inv_d, tg, D, vec);                     \
    return cudaSuccess;                                                                    \
  }
  NORM_ROWS(2)
  NORM_ROWS(4)
  NORM_ROWS(8)
#undef NORM_ROWS
  return cudaErrorInvalidValue;
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
    if (K <= 0 || K > kMaxCpt * kThreads * (x_is_bf16 ? 8 : 4))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e =
        x_is_bf16 ? launch_quant(static_cast<const __nv_bfloat16*>(x), tg, M, K, st)
                  : launch_quant(static_cast<const float*>(x), tg, M, K, st);
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
    if (D <= 0 || D > kMaxNormCpt * kThreads * (x_is_bf16 ? 8 : 4))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaErrorInvalidValue;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* xf = static_cast<const float*>(x);
#define NORM_NS(N)                                                                       \
  if (ns == N)                                                                           \
    e = x_is_bf16 ? launch_norm<__nv_bfloat16, N>(xb, scale, eps, inv_d, tg, M, D, st)   \
                  : launch_norm<float, N>(xf, scale, eps, inv_d, tg, M, D, st);
    NORM_NS(1)
    NORM_NS(2)
    NORM_NS(3)
#undef NORM_NS
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* smooth_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
