// W4A8 GEMM: int8 X (M,K) times int4 W packed two per byte along K, with
// int32 accumulation and the dequantization epilogue
// Y[m,n] = float(acc[m,n]) * dx[m] * dw[n], written as bf16 or f32.
//
// Replaces the Pallas TPU kernel repro/kernels/int4_matmul.py:_kernel (with
// its _unpack; pallas_call at int4_matmul.py:81).
//
// Weight layout: W is stored (N, K/2), K contiguous — the transpose of the
// reference's (K/2, N), for the reason int8_matmul.cu gives (s8 mma.sync
// wants four consecutive K values of one column per register).  Byte r of
// a row holds K index 2r in its low nibble and 2r+1 in its high nibble,
// both two's complement.
//
// Bound on the H100: bytes at decode.  The packed weight, 0.5 byte per
// weight, is read once; M = B*(gamma+1) or B*nodes (tens of rows) gives
// 4*M int8 operations per weight byte, far below the ~590 where the tensor
// cores would bound it.  At prefill (M ~ 4096) operations.
//
// Design: int8_matmul.cu's, with the weight tile staged packed.  64x64
// output tiles, 4 warps each owning a 32x32 sub-tile of mma.sync.m16n8k32
// s8 products with int32 accumulators; K advances in 64-wide tiles, double
// buffered through shared memory by cp.async — X as 64-byte rows, W as
// 32-byte packed rows, so only the packed bytes cross from device memory.
// Each B fragment register (four consecutive K values of one column) is
// built from one 16-bit shared-memory load: the four nibbles are spread to
// the four bytes and sign-extended in registers; no unpacked weight is
// ever written to memory.  Decode shapes split K across blocks with exact
// int32 atomicAdd into a workspace and a separate epilogue (mma_s8.cuh);
// integer sums are exact and the epilogue rounds as the plain version
// does, so the output equals it bit for bit.  When K is not a multiple of
// 32 (packed rows not 16-byte aligned) the tiles are staged by byte loads
// instead of cp.async; rows past M or N and K past the chunk are zeros.
#include "mma_s8.cuh"

namespace {

constexpr int LDA = BK + 16;       // X tile row stride in bytes
constexpr int BKP = BK / 2;        // packed bytes per W tile row
constexpr int LDB = BKP + 16;      // W tile row stride: conflict-free 16-bit reads

// Four int4 values in the low 16 bits of p (nibble i = K offset i) → four
// sign-extended int8 values, byte i = K offset i.
__device__ __forceinline__ unsigned unpack4(unsigned p) {
  const unsigned x = (p & 0xFu) | ((p & 0xF0u) << 4) | ((p & 0xF00u) << 8) |
                     ((p & 0xF000u) << 12);
  return x | (((x >> 3) & 0x01010101u) * 0xF0u);
}

// Stage the X tile (64 rows x 64 K bytes, rows m0..) and the packed W tile
// (64 rows x 32 bytes, rows n0..) at K index k (even).
template <bool kAligned>
__device__ __forceinline__ void load_tiles(uint8_t* As, uint8_t* Bs, const int8_t* X,
                                           const int8_t* Wp, int M, int N, int K,
                                           int m0, int n0, int k, int k_end) {
  const int K2 = K / 2;
  if (kAligned) {  // K % 32 == 0: every 16-byte chunk is in or out of range whole
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = threadIdx.x + i * kThreads;  // 256 chunks of X
      const int row = c >> 2, col = (c & 3) * 16;
      const bool ok = k + col < k_end && m0 + row < M;
      cp_async16(As + row * LDA + col,
                 ok ? X + static_cast<int64_t>(m0 + row) * K + k + col : X, ok);
    }
    const int row = threadIdx.x >> 1, col = (threadIdx.x & 1) * 16;  // 128 chunks of W
    const bool ok = k + 2 * col < k_end && n0 + row < N;
    cp_async16(Bs + row * LDB + col,
               ok ? Wp + static_cast<int64_t>(n0 + row) * K2 + k / 2 + col : Wp, ok);
  } else {
    for (int i = threadIdx.x; i < BM * BK; i += kThreads) {
      const int row = i / BK, col = i % BK;
      const bool ok = k + col < k_end && m0 + row < M;
      As[row * LDA + col] = ok ? X[static_cast<int64_t>(m0 + row) * K + k + col] : 0;
    }
    for (int i = threadIdx.x; i < BN * BKP; i += kThreads) {
      const int row = i / BKP, col = i % BKP;
      const bool ok = k + 2 * col < k_end && n0 + row < N;
      Bs[row * LDB + col] =
          ok ? Wp[static_cast<int64_t>(n0 + row) * K2 + k / 2 + col] : 0;
    }
  }
}

template <typename OutT, bool kAligned>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ Wp,
                   const float* __restrict__ dx, const float* __restrict__ dw,
                   OutT* __restrict__ out, int* __restrict__ ws, int M, int N,
                   int K, int k_chunk) {
  __shared__ __align__(16) uint8_t As[2][BM * LDA];
  __shared__ __align__(16) uint8_t Bs[2][BN * LDB];

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
  if (ktiles > 0)
    load_tiles<kAligned>(As[0], Bs[0], X, Wp, M, N, K, m0, n0, k_begin, k_end);
  cp_async_commit();
  for (int t = 0; t < ktiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ktiles)
      load_tiles<kAligned>(As[buf ^ 1], Bs[buf ^ 1], X, Wp, M, N, K, m0, n0,
                           k_begin + (t + 1) * BK, k_end);
    cp_async_commit();
    cp_async_wait_1();  // tile t has landed; tile t+1 may still be in flight
    __syncthreads();
    const uint8_t* A = As[buf];
    const uint8_t* B = Bs[buf];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[2][4], b[4][2];
      load_a(a, A, LDA, wm, kk, g, tig);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // K offsets kk + 4*tig .. +3 and kk + 16 + 4*tig .. +3 of column
        // wn + 8j + g: two packed bytes each
        const uint8_t* c = B + (wn + j * 8 + g) * LDB + kk / 2 + tig * 2;
        b[j][0] = unpack4(*reinterpret_cast<const uint16_t*>(c));
        b[j][1] = unpack4(*reinterpret_cast<const uint16_t*>(c + 8));
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

template <typename OutT, bool kAligned>
void launch(const int8_t* X, const int8_t* Wp, const float* dx, const float* dw,
            void* out, int* ws, int M, int N, int K, int k_chunk, int splits,
            cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  OutT* o = static_cast<OutT*>(out);
  int4_matmul_kernel<OutT, kAligned><<<grid, kThreads, 0, st>>>(X, Wp, dx, dw, o, ws,
                                                                M, N, K, k_chunk);
  if (splits > 1) launch_epilogue<OutT>(ws, dx, dw, o, M, N, st);
}

template <typename OutT>
void launch_aligned(bool aligned, const int8_t* X, const int8_t* Wp, const float* dx,
                    const float* dw, void* out, int* ws, int M, int N, int K,
                    int k_chunk, int splits, cudaStream_t st) {
  if (aligned)
    launch<OutT, true>(X, Wp, dx, dw, out, ws, M, N, K, k_chunk, splits, st);
  else
    launch<OutT, false>(X, Wp, dx, dw, out, ws, M, N, K, k_chunk, splits, st);
}

}  // namespace

// X: (M, K) int8, Wp: (N, K/2) int8 (two int4 per byte), both K-contiguous,
// K even; aligned != 0 only when K % 32 == 0 and both are 16-byte aligned.
// dx: (M,) f32; dw: (N,) f32; out: (M, N) bf16 (out_is_bf16 != 0) or f32.
// k_chunk is a multiple of 64.  splits > 1 needs ws: (M, N) int32, zeroed.
// Returns cudaGetLastError().
extern "C" int int4_matmul_launch(const int8_t* X, const int8_t* Wp,
                                  const float* dx, const float* dw, void* out,
                                  int out_is_bf16, int* ws, int M, int N, int K,
                                  int k_chunk, int splits, int aligned,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > 0 && N > 0) {
    if (out_is_bf16)
      launch_aligned<__nv_bfloat16>(aligned != 0, X, Wp, dx, dw, out, ws, M, N, K,
                                    k_chunk, splits, st);
    else
      launch_aligned<float>(aligned != 0, X, Wp, dx, dw, out, ws, M, N, K, k_chunk,
                            splits, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int4_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
