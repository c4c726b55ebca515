// W8A8 GEMM: int8 X (M,K) times int8 W with int32 accumulation and the
// dequantization epilogue  Y[m,n] = float(acc[m,n]) * dx[m] * dw[n]
// (paper Eq. 8 / Eq. 10), written as bf16 or f32.
//
// Replaces the Pallas TPU kernel repro/kernels/int8_matmul.py:_kernel
// (pallas_call at int8_matmul.py:78).
//
// Weight layout: W is stored (N, K), K contiguous — the transpose of the
// reference's (K, N).  The s8 tensor-core mma (m16n8k32) wants four
// consecutive K values of one column in each 32-bit register, ldmatrix.trans
// exists only for 16-bit types, and transposing at every call would double
// the bytes this kernel exists to save; so quant/int8.py and the bridge
// store the prepared weight transposed, once.
//
// Bound on the H100: at decode (M = B*(gamma+1), tens of rows) bytes — the
// int8 weight is read once, 2*M operations per weight byte, far below the
// ~590 int8 operations per byte where the tensor cores would bound it.  At
// prefill (M ~ 4096) operations.
//
// Design: 64x64 output tiles, 4 warps each owning a 32x32 sub-tile of
// mma.sync.m16n8k32 s8 products with int32 accumulators in registers.  K
// advances in 64-wide tiles staged through shared memory by cp.async, double
// buffered so the next tile's loads overlap the current tile's products;
// rows of 80 bytes keep the fragment reads free of bank conflicts.  Rows and
// columns past M or N are zero-filled by cp.async and never stored.  When
// the output has too few tiles to fill the card (decode), K is split across
// gridDim.z blocks that add their partial sums into an int32 workspace with
// atomicAdd — integer addition is exact and order-free, so the result does
// not depend on the split — and a second kernel applies the epilogue.  The
// epilogue computes (float(acc) * dx) * dw in that order with IEEE rounding,
// as the plain version does, so equal accumulators give equal outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int LDS = BK + 16;   // shared-memory row stride in bytes
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

// Stage the 64x64 byte tiles of X (rows m0..) and W (rows n0..) at column k.
__device__ __forceinline__ void load_tiles(uint8_t* As, uint8_t* Bs,
                                           const int8_t* X, const int8_t* W,
                                           int M, int N, int K, int m0, int n0,
                                           int k, int k_end) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;  // 256 chunks of 16 bytes
    const int row = c >> 2, col = (c & 3) * 16;
    const bool kin = k + col < k_end;
    const bool a_ok = kin && m0 + row < M;
    const bool b_ok = kin && n0 + row < N;
    cp_async16(As + row * LDS + col,
               a_ok ? X + static_cast<int64_t>(m0 + row) * K + k + col : X, a_ok);
    cp_async16(Bs + row * LDS + col,
               b_ok ? W + static_cast<int64_t>(n0 + row) * K + k + col : W, b_ok);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
                   const float* __restrict__ dx, const float* __restrict__ dw,
                   OutT* __restrict__ out, int* __restrict__ ws, int M, int N,
                   int K, int k_chunk) {
  __shared__ __align__(16) uint8_t As[2][BM * LDS];
  __shared__ __align__(16) uint8_t Bs[2][BN * LDS];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, tig = lane & 3;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  const int ktiles = (k_end - k_begin + BK - 1) / BK;
  if (ktiles > 0) load_tiles(As[0], Bs[0], X, W, M, N, K, m0, n0, k_begin, k_end);
  cp_async_commit();
  for (int t = 0; t < ktiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ktiles)
      load_tiles(As[buf ^ 1], Bs[buf ^ 1], X, W, M, N, K, m0, n0,
                 k_begin + (t + 1) * BK, k_end);
    cp_async_commit();
    cp_async_wait_1();  // tile t has landed; tile t+1 may still be in flight
    __syncthreads();
    const uint8_t* A = As[buf];
    const uint8_t* B = Bs[buf];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint8_t* r0 = A + (wm + i * 16 + g) * LDS + kk + tig * 4;
        const uint8_t* r8 = r0 + 8 * LDS;
        a[i][0] = *reinterpret_cast<const unsigned*>(r0);
        a[i][1] = *reinterpret_cast<const unsigned*>(r8);
        a[i][2] = *reinterpret_cast<const unsigned*>(r0 + 16);
        a[i][3] = *reinterpret_cast<const unsigned*>(r8 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* c = B + (wn + j * 8 + g) * LDS + kk + tig * 4;
        b[j][0] = *reinterpret_cast<const unsigned*>(c);
        b[j][1] = *reinterpret_cast<const unsigned*>(c + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // buffer buf is refilled at iteration t+1
  }

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

template <typename OutT>
void launch(const int8_t* X, const int8_t* W, const float* dx, const float* dw,
            void* out, int* ws, int M, int N, int K, int k_chunk, int splits,
            cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  OutT* o = static_cast<OutT*>(out);
  int8_matmul_kernel<OutT><<<grid, kThreads, 0, st>>>(X, W, dx, dw, o, ws, M, N,
                                                      K, k_chunk);
  if (splits > 1) {
    const int64_t total = static_cast<int64_t>(M) * N;
    const int blocks = static_cast<int>(std::min<int64_t>((total + 255) / 256, 4096));
    epilogue_kernel<OutT><<<blocks, 256, 0, st>>>(ws, dx, dw, o, M, N);
  }
}

}  // namespace

// X: (M, K) int8, W: (N, K) int8, both K-contiguous with K % 16 == 0;
// dx: (M,) f32; dw: (N,) f32; out: (M, N) bf16 (out_is_bf16 != 0) or f32.
// splits > 1 needs ws: (M, N) int32, zeroed.  Returns cudaGetLastError().
extern "C" int int8_matmul_launch(const int8_t* X, const int8_t* W,
                                  const float* dx, const float* dw, void* out,
                                  int out_is_bf16, int* ws, int M, int N, int K,
                                  int k_chunk, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > 0 && N > 0) {
    if (out_is_bf16)
      launch<__nv_bfloat16>(X, W, dx, dw, out, ws, M, N, K, k_chunk, splits, st);
    else
      launch<float>(X, W, dx, dw, out, ws, M, N, K, k_chunk, splits, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
