// Parts shared by the int8 and int4 GEMMs (int8_matmul.cu, int4_matmul.cu):
// the 64x64x64 tiling over 4 warps, the cp.async helpers, the s8
// tensor-core product mma.sync.m16n8k32 with int32 accumulators, the
// dequantization epilogue  Y[m,n] = (float(acc) * dx[m]) * dw[n]  (IEEE
// rounding in that order, as the plain versions compute it), and the
// split-K epilogue kernel that applies it to an int32 workspace.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int kThreads = 128;  // 4 warps in a 2x2 grid of 32x32 sub-tiles

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float dequant(int acc, float dx, float dw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), dx), dw);
}

// The A fragments of one warp's two 16-row slices at K offset kk of a
// shared-memory X tile with row stride lda bytes (rows wm.., 32 K bytes).
__device__ __forceinline__ void load_a(unsigned (&a)[2][4], const uint8_t* A, int lda,
                                       int wm, int kk, int g, int tig) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint8_t* r0 = A + (wm + i * 16 + g) * lda + kk + tig * 4;
    const uint8_t* r8 = r0 + 8 * lda;
    a[i][0] = *reinterpret_cast<const unsigned*>(r0);
    a[i][1] = *reinterpret_cast<const unsigned*>(r8);
    a[i][2] = *reinterpret_cast<const unsigned*>(r0 + 16);
    a[i][3] = *reinterpret_cast<const unsigned*>(r8 + 16);
  }
}

// Writes a warp's 32x32 accumulators: the dequantized output when K is not
// split (gridDim.z == 1), else an exact int32 atomicAdd into the workspace.
template <typename OutT>
__device__ __forceinline__ void store_tile(const int (&acc)[2][4][4], int m0, int n0,
                                           int wm, int wn, int g, int tig, int M, int N,
                                           const float* __restrict__ dx,
                                           const float* __restrict__ dw,
                                           OutT* __restrict__ out, int* __restrict__ ws) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = m0 + wm + i * 16 + g + (v >= 2 ? 8 : 0);
        const int n = n0 + wn + j * 8 + tig * 2 + (v & 1);
        if (m < M && n < N) {
          const int64_t o = static_cast<int64_t>(m) * N + n;
          if (gridDim.z == 1)
            store(out + o, dequant(acc[i][j][v], dx[m], dw[n]));
          else
            atomicAdd(ws + o, acc[i][j][v]);
        }
      }
}

template <typename OutT>
__global__ void epilogue_kernel(const int* __restrict__ ws,
                                const float* __restrict__ dx,
                                const float* __restrict__ dw,
                                OutT* __restrict__ out, int M, int N) {
  const int64_t total = static_cast<int64_t>(M) * N;
  for (int64_t o = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       o < total; o += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int m = static_cast<int>(o / N), n = static_cast<int>(o % N);
    store(out + o, dequant(ws[o], dx[m], dw[n]));
  }
}

// Launches the split-K epilogue over the (M, N) workspace.
template <typename OutT>
void launch_epilogue(const int* ws, const float* dx, const float* dw, OutT* out,
                     int M, int N, cudaStream_t st) {
  const int64_t total = static_cast<int64_t>(M) * N;
  const int blocks = static_cast<int>(std::min<int64_t>((total + 255) / 256, 4096));
  epilogue_kernel<OutT><<<blocks, 256, 0, st>>>(ws, dx, dw, out, M, N);
}

}  // namespace
