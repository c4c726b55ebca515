// W4A8 GEMM: int8 X (M,K) times int4 W packed two per byte along K, with
// int32 accumulation and the dequantization epilogue
// Y[m,n] = float(acc[m,n]) * dx[m] * dw[n], written as bf16 or f32.
//
// Replaces the Pallas TPU kernel repro/kernels/int4_matmul.py:_kernel (with
// its _unpack; pallas_call at int4_matmul.py:81).
//
// Weight layout: W is stored (N, K/2), K contiguous — the transpose of the
// reference's (K/2, N), for the reason int8_matmul.cu gives (the s8 tensor
// cores take K-major operands only).  Byte r of a row holds K index 2r in
// its low nibble and 2r+1 in its high nibble, both two's complement: the
// reference's order, kept, so the packed bytes are the reference's.
//
// Bound on the H100 (3.35 TB/s, 1979 int8 TOPS): bytes at decode.  The
// packed weight, 0.5 byte per weight, is read once; M = B*(gamma+1) or
// B*nodes (tens of rows) gives 4*M int8 operations per weight byte, far
// below the ~590 where the tensor cores would bound it; e.g. (24, 4096,
// 12288) moves 25.8 MB: 0.0077 ms.  At prefill (M ~ 4096) operations:
// (4092, 4096, 12288) 0.208 ms.
//
// Design: int8_matmul.cu's, with the ring, the cluster K split, the epilogue
// and the launch shared through gemm_s8.cuh.  The operands are always
// swapped: a block's A tile is 64 (one consumer warpgroup) or 128 (two) W
// rows, and its B tile NW rows of X, wgmma.m64nNk32.s32.s8.s8 with
// N = NW.  For M <= 256, NW is M rounded up to a built width (8, 24, 48,
// 96, 192, 256), all of X's rows sit in one B tile, and every packed weight
// byte is read once; K is split across a cluster where the W tiles alone
// leave SMs idle.  For M > 256 the blocks tile X in 256-row B tiles over a
// second grid dimension (128 x 256 output tiles, as int8_matmul's tiled
// regime, transposed), M tiles fastest so a wave shares W tiles.
// One producer warp streams, per 128-value K step, the packed W tile (A_ROWS
// rows x 64 bytes, 64-byte swizzle) and the X tile (NW rows x 128 bytes,
// 128-byte swizzle) through a ring of stages: with TMA where the rows are
// 16-byte multiples and aligned (K % 32 == 0, 16-byte aligned bases), else
// with ordinary byte loads into the same swizzled layout (then a proxy
// fence before the consumers' wgmma reads it).  The plan picks the producer
// from the shapes and pointers alone (kernels/int4_matmul.py gemm_plan).
// The packed W crosses from device memory at 0.5 byte per weight and is
// unpacked only in registers: each consumer thread loads, per k32 slice and
// fragment row, the two 16-bit halves holding its K values, and builds its
// two wgmma A-fragment registers with 6 integer operations per 8 weights
// (unpack8): (p << 4) & 0xF0F0F0F0 and p & 0xF0F0F0F0 give the low and high
// nibbles as signed bytes equal to 16*w (exact; -8 gives -128), and two
// byte permutes put them in K order.  wgmma then takes A from registers
// (mma_rs) and X from shared memory.  The int32 sum is 16 times the true
// one (|16 w x| <= 128*127, so below 2^31 for K < 132,000) and is shifted
// back by 4 before the epilogue, which rounds as the plain version does, so
// the output equals int4_matmul_ref bit for bit and a row's bits depend
// neither on M, the regime, the producer nor the split.
#include "gemm_s8.cuh"

namespace {

constexpr int KP = KT / 2;  // packed W bytes per row and ring stage

// Two halves of packed int4 (h0: K k..k+3, h1: K k+16..k+19, two weights a
// byte, low nibble first) -> the A fragment registers of K k..k+3 and
// K k+16..k+19, each weight as the signed byte 16*w.
__device__ __forceinline__ void unpack8(uint32_t h0, uint32_t h1, uint32_t& lo,
                                        uint32_t& hi) {
  const uint32_t p = __byte_perm(h0, h1, 0x5410);  // K k,k+1 | k+2,k+3 | k+16,17 | k+18,19
  const uint32_t t = (p << 4) & 0xF0F0F0F0u;       // 16 w of K k, k+2, k+16, k+18
  const uint32_t u = p & 0xF0F0F0F0u;              // 16 w of K k+1, k+3, k+17, k+19
  lo = __byte_perm(t, u, 0x5140);
  hi = __byte_perm(t, u, 0x7362);
}

__device__ __forceinline__ uint32_t lds16(const uint8_t* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

template <int NW, int WGS, bool TMA>
__global__ void __launch_bounds__(WGS * 128 + 32, NW <= 64 ? 2 : 1)
int4_gemm_kernel(const __grid_constant__ CUtensorMap tmW,
                 const __grid_constant__ CUtensorMap tmX, const int8_t* __restrict__ W,
                 const int8_t* __restrict__ X, const float* __restrict__ dx,
                 const float* __restrict__ dw, void* __restrict__ out, int out_bf16, int M,
                 int N, int K, int ktiles, int kt_per_split, int stages, int cluster) {
  constexpr int A_ROWS = 64 * WGS, W_BYTES = A_ROWS * KP, STAGE = W_BYTES + NW * KT;
  constexpr int CONSUMERS = WGS * 128;
  extern __shared__ uint8_t smem_raw[];
  const Ring ring(smem_raw, stages);

  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  const int rank = blockIdx.x % cluster;
  const int a0 = blockIdx.x / cluster * A_ROWS;  // first W row (n) of the block
  const int b0 = blockIdx.y * NW;                // first X row (m)
  const int kt0 = rank * kt_per_split;
  const int nk = max(0, min(ktiles, kt0 + kt_per_split) - kt0);

  if (threadIdx.x == 0) ring.init(TMA ? 1 : 32, 4 * WGS);
  __syncthreads();

  uint32_t acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0;
  if (wg == WGS) {
    if (TMA) {
      // one thread keeps the ring full
      if (lane == 0) {
        for (int t = 0; t < nk; ++t) {
          ring.wait_empty(t);
          uint8_t* st = ring.stage(t, STAGE);
          mbar_expect_tx(ring.full_bar(t), STAGE);
          tma_load_2d(st, &tmW, ring.full_bar(t), (kt0 + t) * KP, a0);
          tma_load_2d(st + W_BYTES, &tmX, ring.full_bar(t), (kt0 + t) * KT, b0);
        }
      }
    } else {
      // the whole warp stages the same swizzled layout with byte loads,
      // zero past N, M and K
      const int KB = K / 2;
      for (int t = 0; t < nk; ++t) {
        ring.wait_empty(t);
        uint8_t* st = ring.stage(t, STAGE);
        const int kp = (kt0 + t) * KP, kx = (kt0 + t) * KT;
        for (int i = lane; i < W_BYTES; i += 32) {
          const int n = a0 + i / KP, c = kp + i % KP;
          st[i ^ (((i >> 7) & 3) << 4)] =
              n < N && c < KB ? W[static_cast<int64_t>(n) * KB + c] : 0;
        }
        for (int i = lane; i < NW * KT; i += 32) {
          const int m = b0 + i / KT, c = kx + i % KT;
          st[W_BYTES + (i ^ (((i >> 7) & 7) << 4))] =
              m < M && c < K ? X[static_cast<int64_t>(m) * K + c] : 0;
        }
        fence_proxy_async();  // the X tile is read by wgmma (the async proxy)
        mbar_arrive(ring.full_bar(t));
      }
    }
  } else {
    // rows r and r + 8 of the W tile feed this thread's A fragments; the
    // 64-byte swizzle moves 16-byte chunk c of row r to chunk c ^ ((r/2) % 4)
    const int r = wg * 64 + (threadIdx.x / 32 % 4) * 16 + lane / 4;
    const int sw = (r >> 1) & 3;
    int off[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) off[c] = r * KP + ((c ^ sw) << 4) + 2 * (lane & 3);
    // Step t's A fragments are read by its products until the wait that
    // retires them, one step later.  Two fragment buffers, a step each in
    // turn, and each buffer held live (fence_regs) past that wait, keep the
    // compiler from reusing their registers for the next step's unpack while
    // the products are in flight.
    uint32_t fa[4][4] = {}, fb[4][4] = {};
    auto step = [&](int t, uint32_t (&cur)[4][4], uint32_t (&prev)[4][4]) {
      ring.wait_full(t);
      const uint8_t* w = ring.stage(t, STAGE);
      const uint8_t* x = w + W_BYTES;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint8_t* p = w + off[c];
        unpack8(lds16(p), lds16(p + 8), cur[c][0], cur[c][2]);
        unpack8(lds16(p + 8 * KP), lds16(p + 8 * KP + 8), cur[c][1], cur[c][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < 4; ++c) Wgmma<NW>::mma_rs(acc, cur[c], sw128_desc(x + 32 * c));
      wgmma_commit();
      wgmma_wait<1>();  // the products of stage t-1 are done: release it
      fence_regs(acc);
#pragma unroll
      for (int c = 0; c < 4; ++c) fence_regs(prev[c]);
      if (t > 0 && lane == 0) ring.release(t - 1);
    };
    for (int t = 0; t < nk; t += 2) {
      step(t, fa, fb);
      if (t + 1 < nk) step(t + 1, fb, fa);
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int c = 0; c < 4; ++c) fence_regs(fa[c]), fence_regs(fb[c]);
  }
  finish<NW, WGS, true, 4>(acc, ring.tiles, cluster, rank, a0, b0, dx, dw, out, out_bf16, M,
                           N);
}

template <int NW, int WGS, bool TMA>
cudaError_t launch(const int8_t* X, const int8_t* W, const float* dx, const float* dw,
                   void* out, int out_bf16, int M, int N, int K, int cluster, int stages,
                   int smem, cudaStream_t st) {
  constexpr int A_ROWS = 64 * WGS;
  if (cluster > 1 && smem < kReserve + 256 * WGS * NW)  // the int32 partial sums
    return cudaErrorInvalidValue;
  CUtensorMap mw = {}, mx = {};
  if (TMA && !(tensor_map(&mw, W, N, K / 2, A_ROWS, KP, CU_TENSOR_MAP_SWIZZLE_64B) &&
               tensor_map(&mx, X, M, K, NW, KT, CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  static int smem_set[kMaxDevices] = {};
  const int ktiles = (K + KT - 1) / KT;
  const int per = (ktiles + cluster - 1) / cluster;
  const dim3 grid((N + A_ROWS - 1) / A_ROWS * cluster, (M + NW - 1) / NW, 1);
  return launch_gemm(int4_gemm_kernel<NW, WGS, TMA>, smem_set, grid, WGS * 128 + 32, smem,
                     cluster, st, mw, mx, W, X, dx, dw, out, out_bf16, M, N, K, ktiles, per,
                     stages, cluster);
}

}  // namespace

// X: (M, K) int8, Wp: (N, K/2) int8 (two int4 per byte), both K-contiguous,
// K even; dx: (M,) f32; dw: (N,) f32; out: (M, N) bf16 (out_is_bf16 != 0) or
// f32.  The plan (kernels/int4_matmul.py gemm_plan): width = wgmma N (the X
// rows of a block), tile_n = W rows of a block (64 or 128), cluster = blocks
// splitting K (1, 2, 4 or 8; only when M <= width), stages and smem =
// dynamic shared memory bytes; tma != 0 streams with TMA, which needs
// K % 32 == 0 and 16-byte aligned X and Wp.  A plan outside the built
// kernels is refused with cudaErrorInvalidValue.  Returns the launch's error
// or cudaGetLastError().
extern "C" int int4_matmul_launch(const int8_t* X, const int8_t* Wp, const float* dx,
                                  const float* dw, void* out, int out_is_bf16, int M,
                                  int N, int K, int width, int tile_n, int cluster,
                                  int stages, int smem, int tma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (tma && encoder() == nullptr)
    return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const bool tma_ok = K % 32 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(Wp) % 16 == 0;
  if (K <= 0 || K % 2 || stages < 1 || !cluster_ok(cluster) || (tma && !tma_ok) ||
      (M > width && (width != 256 || cluster != 1)) ||
      smem < kReserve + stages * (tile_n * KP + width * KT))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
#define INT4_GEMM(NW, WGS)                                                                 \
  if (width == NW && tile_n == 64 * WGS)                                                   \
    e = tma ? launch<NW, WGS, true>(X, Wp, dx, dw, out, out_is_bf16, M, N, K, cluster,     \
                                    stages, smem, st)                                      \
            : launch<NW, WGS, false>(X, Wp, dx, dw, out, out_is_bf16, M, N, K, cluster,    \
                                     stages, smem, st);
  INT4_GEMM(8, 1)
  INT4_GEMM(24, 1)
  INT4_GEMM(48, 1)
  INT4_GEMM(96, 2)
  INT4_GEMM(192, 2)
  INT4_GEMM(256, 2)
#undef INT4_GEMM
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int4_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
