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
// as the plain version does, so equal accumulators give equal outputs.  The
// parts shared with the int4 GEMM are in mma_s8.cuh.
#include "mma_s8.cuh"

namespace {

constexpr int LDS = BK + 16;   // shared-memory row stride in bytes

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
      load_a(a, A, LDS, wm, kk, g, tig);
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

  store_tile(acc, m0, n0, wm, wn, g, tig, M, N, dx, dw, out, ws);
}

template <typename OutT>
void launch(const int8_t* X, const int8_t* W, const float* dx, const float* dw,
            void* out, int* ws, int M, int N, int K, int k_chunk, int splits,
            cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  OutT* o = static_cast<OutT*>(out);
  int8_matmul_kernel<OutT><<<grid, kThreads, 0, st>>>(X, W, dx, dw, o, ws, M, N,
                                                      K, k_chunk);
  if (splits > 1) launch_epilogue<OutT>(ws, dx, dw, o, M, N, st);
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
