// W8A8 GEMM: int8 X (M,K) times int8 W with int32 accumulation and the
// dequantization epilogue  Y[m,n] = float(acc[m,n]) * dx[m] * dw[n]
// (paper Eq. 8 / Eq. 10), written as bf16 or f32.
//
// Replaces the Pallas TPU kernel repro/kernels/int8_matmul.py:_kernel (:26,
// pallas_call at int8_matmul.py:78).
//
// Weight layout: W is stored (N, K), K contiguous — the transpose of the
// reference's (K, N) — once, in quant/int8.py and the bridge.  The s8
// tensor-core products (wgmma) take both operands K-major only, so X (M, K)
// and W (N, K) are both used as they lie.
//
// Bound on the H100 (3.35 TB/s, 1979 int8 TOPS):
// - decode and verify windows (M <= 256): bytes.  The weight is read once,
//   2*M operations per weight byte, below the ~590 operations per byte where
//   the tensor cores would bound it even at M = 256; e.g. (24, 4096, 12288)
//   moves 50 MB: 0.0152 ms.
// - prefill (M > 256, e.g. (4092, 4096, 12288)): int8 operations, 0.208 ms.
//
// Design: one kernel, one launch per GEMM, two regimes chosen from M alone by
// the launch plan (kernels/int8_matmul.py gemm_plan):
// - M <= 256, operands swapped: each block computes a Y^T tile.  A tile of
//   64 (or 128, two warpgroups) W rows is wgmma's A operand and all M rows of
//   X are its B operand, wgmma.m64nNk32.s32.s8.s8 with N = M rounded up to a
//   width s8 wgmma takes.  The widths built (WIDTHS: 8, 24, 48, 96, 192,
//   256) are those of the main path's windows (M 4, 24, 48, 88, 176) and the
//   regime's end (256); X is a small share of the bytes at decode, so a
//   coarser width costs little (tools/gemm_bench.py times M 12, 30, 60, 110).  So every weight byte is read
//   once for any M <= 256 (the earlier mma.sync kernel padded M to 64-row
//   tiles and read W once per row tile: twice at M = 88).  Where N / 64 gives
//   too few tiles to fill the card, K is split across a thread-block cluster
//   of up to 8 blocks: each block stores its int32 accumulators in its own
//   shared memory, and after a cluster barrier each block sums its share of
//   them from every block's shared memory (distributed shared memory) and
//   applies the epilogue; a second cluster barrier keeps every block alive
//   until the others have read it.  Integer sums are exact and order-free,
//   so the result does not depend on the split: no workspace, no atomics, no
//   second kernel.
// - M > 256: 128 x 256 output tiles, X the A operand of two consumer
//   warpgroups (64 rows each) and a 256-row W tile the B operand,
//   wgmma.m64n256k32; blocks walk M fastest so a wave shares W tiles.
// Both: one producer warp streams the two operand tiles of each 128-byte K
// step through a ring of stages with TMA (cp.async.bulk.tensor, 128-byte
// swizzle, zero fill past M, N and K), full/empty mbarriers between it and
// the consumer warpgroups, which keep one wgmma group in flight while the
// next stage lands.  The epilogue computes (float(acc) * dx) * dw in that
// order with IEEE rounding (gemm_s8.cuh dequant), as the plain version does,
// so equal accumulators give equal outputs and a row's bits depend neither on
// M, the regime nor the split.  The ring, the cluster reduction, the
// epilogue and the launch are gemm_s8.cuh's, shared with int4_matmul.cu.
//
// Batched over experts (E > 1): the W8A8 branch of the MoE expert product
// (repro/models/moe.py:72-87 _expert_linear, a jnp dot_general over experts
// in the reference, not a Pallas kernel), X (E, C, K) times W (E, N, K) ->
// (E, C, N), is this kernel with the experts as the grid's z dimension: one
// launch per expert linear.  Expert e's blocks read the tensors as (E*C, K)
// and (E*N, K) row matrices from rows e*C and e*N, with M = C; the plan is
// the one-expert plan of (C, N, K) with E times the tiles (gemm_plan's E).
// An X tile's `width` rows (or a W tile's rows) that run past expert e's C
// (N) rows into expert e+1's are multiplied but never written: the epilogue
// masks m < C and n < N, and past the last expert TMA fills zeros.  At
// decode (C 3, moonshot's 64 experts of 1408 x 2048) the swapped regime reads
// every weight byte once: 22 tiles of 64 W rows per expert, 1408 blocks, no
// K split.  torch has no batched int8 product with int32 sums on CUDA, and
// torch._int_mm is 2-D and needs more than 16 rows.
#include "gemm_s8.cuh"

namespace {

template <int NW, int WGS, bool SWAP>
__global__ void __launch_bounds__(WGS * 128 + 32, NW <= 64 ? 2 : 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap tmA,
                 const __grid_constant__ CUtensorMap tmB,
                 const float* __restrict__ dx, const float* __restrict__ dw,
                 void* __restrict__ out, int out_bf16, int M, int N, int ktiles,
                 int kt_per_split, int stages, int cluster) {
  constexpr int A_ROWS = 64 * WGS, A_BYTES = A_ROWS * KT, STAGE = A_BYTES + NW * KT;
  constexpr int CONSUMERS = WGS * 128;
  extern __shared__ uint8_t smem_raw[];
  const Ring ring(smem_raw, stages);

  const int wg = threadIdx.x / 128;
  const int rank = blockIdx.x % cluster;
  const int a0 = blockIdx.x / cluster * A_ROWS, b0 = blockIdx.y * NW;
  // expert e (blockIdx.z): its rows of X and W, its scales and its output
  const int e = blockIdx.z;
  const int a_row = (SWAP ? e * N : e * M) + a0, b_row = (SWAP ? e * M : e * N) + b0;
  dx += static_cast<int64_t>(e) * M;
  dw += static_cast<int64_t>(e) * N;
  out = static_cast<uint8_t*>(out) + static_cast<int64_t>(e) * M * N * (out_bf16 ? 2 : 4);
  const int kt0 = rank * kt_per_split;
  const int nk = max(0, min(ktiles, kt0 + kt_per_split) - kt0);

  if (threadIdx.x == 0) ring.init(1, 4 * WGS);
  __syncthreads();

  uint32_t acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0;
  if (wg == WGS) {
    // producer warp: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS) {
      for (int t = 0; t < nk; ++t) {
        ring.wait_empty(t);
        uint8_t* st = ring.stage(t, STAGE);
        const int k = (kt0 + t) * KT;
        mbar_expect_tx(ring.full_bar(t), STAGE);
        tma_load_2d(st, &tmA, ring.full_bar(t), k, a_row);
        tma_load_2d(st + A_BYTES, &tmB, ring.full_bar(t), k, b_row);
      }
    }
  } else {
    const int lane = threadIdx.x & 31;
    for (int t = 0; t < nk; ++t) {
      ring.wait_full(t);
      const uint8_t* a = ring.stage(t, STAGE) + wg * 64 * KT;
      const uint8_t* b = ring.stage(t, STAGE) + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT; kk += 32)
        Wgmma<NW>::mma(acc, sw128_desc(a + kk), sw128_desc(b + kk));
      wgmma_commit();
      wgmma_wait<1>();  // the products of stage t-1 are done: release it
      fence_regs(acc);
      if (t > 0 && lane == 0) ring.release(t - 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }
  finish<NW, WGS, SWAP, 0>(acc, ring.tiles, cluster, rank, a0, b0, dx, dw, out, out_bf16, M,
                           N);
}

template <int NW, int WGS, bool SWAP>
cudaError_t launch(const int8_t* X, const int8_t* W, const float* dx, const float* dw,
                   void* out, int out_bf16, int E, int M, int N, int K, int cluster,
                   int stages, int smem, cudaStream_t st) {
  constexpr int A_ROWS = 64 * WGS;
  if (cluster > 1 && smem < kReserve + 256 * WGS * NW)  // the int32 partial sums
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const bool ok = SWAP ? tensor_map(&ma, W, E * N, K, A_ROWS, KT, sw) &&
                             tensor_map(&mb, X, E * M, K, NW, KT, sw)
                       : tensor_map(&ma, X, E * M, K, A_ROWS, KT, sw) &&
                             tensor_map(&mb, W, E * N, K, NW, KT, sw);
  if (!ok) return cudaErrorInvalidValue;
  static int smem_set[kMaxDevices] = {};
  const int ktiles = (K + KT - 1) / KT;
  const int per = (ktiles + cluster - 1) / cluster;
  const dim3 grid = SWAP ? dim3((N + A_ROWS - 1) / A_ROWS * cluster, 1, E)
                         : dim3((M + A_ROWS - 1) / A_ROWS, (N + NW - 1) / NW, E);
  return launch_gemm(int8_gemm_kernel<NW, WGS, SWAP>, smem_set, grid, WGS * 128 + 32, smem,
                     cluster, st, ma, mb, dx, dw, out, out_bf16, M, N, ktiles, per, stages,
                     cluster);
}

}  // namespace

// X: (E, M, K) int8, W: (E, N, K) int8, both K-contiguous and 16-byte aligned
// with K % 16 == 0; dx: (E, M) f32; dw: (E, N) f32; out: (E, M, N) bf16
// (out_is_bf16 != 0) or f32; E = 1 is the plain GEMM.  The plan
// (kernels/int8_matmul.py gemm_plan): swap = 1 for the
// swapped regime (M <= 256), width = wgmma N, tile_n = the N extent of a
// block's output tile (64 or 128 W rows swapped, 256 otherwise), cluster =
// blocks splitting K (1, 2, 4 or 8), stages and smem = dynamic shared memory
// bytes.  A plan outside the built kernels is refused with
// cudaErrorInvalidValue.  Returns the launch's error or cudaGetLastError().
extern "C" int int8_matmul_launch(const int8_t* X, const int8_t* W, const float* dx,
                                  const float* dw, void* out, int out_is_bf16, int E,
                                  int M, int N, int K, int swap, int width, int tile_n,
                                  int cluster, int stages, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (E > 65535 || static_cast<int64_t>(E) * (M > N ? M : N) > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (encoder() == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const int a_rows = swap ? tile_n : 128;  // rows of a block's A tile
  if (K <= 0 || K % 16 || stages < 1 || !cluster_ok(cluster) || (!swap && cluster != 1) ||
      (swap && M > width) || smem < kReserve + stages * (a_rows + width) * KT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
#define INT8_GEMM(NW, WGS, SWAP)                                                     \
  if ((swap != 0) == SWAP && width == NW && tile_n == (SWAP ? 64 * WGS : NW))         \
    e = launch<NW, WGS, SWAP>(X, W, dx, dw, out, out_is_bf16, E, M, N, K, cluster,     \
                              stages, smem, st);
  INT8_GEMM(8, 1, true)
  INT8_GEMM(24, 1, true)
  INT8_GEMM(48, 1, true)
  INT8_GEMM(96, 2, true)
  INT8_GEMM(192, 2, true)
  INT8_GEMM(256, 2, true)
  INT8_GEMM(256, 2, false)
#undef INT8_GEMM
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
