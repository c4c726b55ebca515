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
// order with IEEE rounding (mma_s8.cuh dequant), as the plain version does,
// so equal accumulators give equal outputs and a row's bits depend neither on
// M, the regime nor the split.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "mma_s8.cuh"
#include "wgmma_s8.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int KT = 128;        // K bytes per stage: one 128-byte swizzled row
constexpr int kReserve = 2048; // alignment slack + barriers, before the tiles
constexpr int kMaxDevices = 64;

template <int NW, int WGS, bool SWAP>
__global__ void __launch_bounds__(WGS * 128 + 32, NW <= 64 ? 2 : 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap tmA,
                 const __grid_constant__ CUtensorMap tmB,
                 const float* __restrict__ dx, const float* __restrict__ dw,
                 void* __restrict__ out, int out_bf16, int M, int N, int ktiles,
                 int kt_per_split, int stages, int cluster) {
  constexpr int A_ROWS = 64 * WGS, A_BYTES = A_ROWS * KT, STAGE = A_BYTES + NW * KT;
  constexpr int R = NW / 2, CONSUMERS = WGS * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + stages;
  uint8_t* tiles = base + 1024;  // 1024-aligned, as the 128-byte swizzle needs

  const int wg = threadIdx.x / 128;
  const int rank = blockIdx.x % cluster;
  const int a0 = blockIdx.x / cluster * A_ROWS, b0 = blockIdx.y * NW;
  const int kt0 = rank * kt_per_split;
  const int nk = max(0, min(ktiles, kt0 + kt_per_split) - kt0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WGS);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == WGS) {
    // producer warp: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % stages;
        if (t >= stages) mbar_wait(&empty[s], (t / stages - 1) & 1);
        uint8_t* st = tiles + s * STAGE;
        const int k = (kt0 + t) * KT;
        mbar_expect_tx(&full[s], STAGE);
        tma_load_2d(st, &tmA, &full[s], k, a0);
        tma_load_2d(st + A_BYTES, &tmB, &full[s], k, b0);
      }
    }
  } else {
    uint32_t acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0;
    const int lane = threadIdx.x & 31;
    for (int t = 0; t < nk; ++t) {
      const int s = t % stages;
      mbar_wait(&full[s], (t / stages) & 1);
      const uint8_t* a = tiles + s * STAGE + wg * 64 * KT;
      const uint8_t* b = tiles + s * STAGE + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT; kk += 32)
        Wgmma<NW>::mma(acc, sw128_desc(a + kk), sw128_desc(b + kk));
      wgmma_commit();
      wgmma_wait<1>();  // the products of stage t-1 are done: release it
      fence_regs(acc);
      if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % stages]);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int row = wg * 64 + (threadIdx.x / 32 % 4) * 16 + lane / 4;
    const int col = 2 * (lane % 4);
    if (cluster == 1) {
#pragma unroll
      for (int j = 0; j < R / 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int ar = a0 + row + 8 * (v >> 1), bc = b0 + 8 * j + col + (v & 1);
          const int m = SWAP ? bc : ar, n = SWAP ? ar : bc;
          if (m < M && n < N) {
            const float y = dequant(static_cast<int>(acc[4 * j + v]), dx[m], dw[n]);
            const int64_t o = static_cast<int64_t>(m) * N + n;
            if (out_bf16)
              store(static_cast<__nv_bfloat16*>(out) + o, y);
            else
              store(static_cast<float*>(out) + o, y);
          }
        }
    } else {
      // every consumer warp is past its last product: the ring may be reused
      asm volatile("bar.sync 1, %0;\n" ::"r"(CONSUMERS) : "memory");
      uint32_t* part = reinterpret_cast<uint32_t*>(tiles);
#pragma unroll
      for (int i = 0; i < R; ++i) part[i * CONSUMERS + threadIdx.x] = acc[i];
    }
  }

  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();  // every block's partial sums are in its shared memory
    if (wg < WGS) {
      const int lane = threadIdx.x & 31;
      const int row = wg * 64 + (threadIdx.x / 32 % 4) * 16 + lane / 4;
      const int col = 2 * (lane % 4);
      const uint32_t* part = reinterpret_cast<const uint32_t*>(tiles);
      const int j0 = rank * (R / 4) / cluster, j1 = (rank + 1) * (R / 4) / cluster;
      for (int j = j0; j < j1; ++j)
        for (int v = 0; v < 4; ++v) {
          const int i = (4 * j + v) * CONSUMERS + threadIdx.x;
          uint32_t sum = 0;
          for (int c = 0; c < cluster; ++c) sum += cl.map_shared_rank(part, c)[i];
          const int ar = a0 + row + 8 * (v >> 1), bc = b0 + 8 * j + col + (v & 1);
          const int m = SWAP ? bc : ar, n = SWAP ? ar : bc;
          if (m < M && n < N) {
            const float y = dequant(static_cast<int>(sum), dx[m], dw[n]);
            const int64_t o = static_cast<int64_t>(m) * N + n;
            if (out_bf16)
              store(static_cast<__nv_bfloat16*>(out) + o, y);
            else
              store(static_cast<float*>(out) + o, y);
          }
        }
    }
    cl.sync();  // no block leaves while another still reads its shared memory
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the CUDA runtime has loaded, so the
// library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_LAZY);
    if (h != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The (rows, K) int8 matrix at `p`, K contiguous, in boxes of box_rows rows
// by 128 bytes with 128-byte swizzle; zero fill outside it.
bool tensor_map(CUtensorMap* map, const int8_t* p, int rows, int K, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {KT, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(p), dims,
                   strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NW, int WGS, bool SWAP>
cudaError_t launch(const int8_t* X, const int8_t* W, const float* dx, const float* dw,
                   void* out, int out_bf16, int M, int N, int K, int cluster, int stages,
                   int smem, cudaStream_t st) {
  constexpr int A_ROWS = 64 * WGS;
  if (cluster > 1 && smem < kReserve + 256 * WGS * NW)  // the int32 partial sums
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const bool ok = SWAP ? tensor_map(&ma, W, N, K, A_ROWS) && tensor_map(&mb, X, M, K, NW)
                       : tensor_map(&ma, X, M, K, A_ROWS) && tensor_map(&mb, W, N, K, NW);
  if (!ok) return cudaErrorInvalidValue;
  auto kern = int8_gemm_kernel<NW, WGS, SWAP>;
  // the largest dynamic shared memory allowed so far, per device: the
  // attribute is set on the current device only
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set[dev] = smem;
  }
  const int ktiles = (K + KT - 1) / KT;
  const int per = (ktiles + cluster - 1) / cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = SWAP ? dim3((N + A_ROWS - 1) / A_ROWS * cluster, 1, 1)
                     : dim3((M + A_ROWS - 1) / A_ROWS, (N + NW - 1) / NW, 1);
  cfg.blockDim = dim3(WGS * 128 + 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, ma, mb, dx, dw, out, out_bf16, M, N, ktiles, per,
                            stages, cluster);
}

}  // namespace

// X: (M, K) int8, W: (N, K) int8, both K-contiguous and 16-byte aligned with
// K % 16 == 0; dx: (M,) f32; dw: (N,) f32; out: (M, N) bf16 (out_is_bf16 != 0)
// or f32.  The plan (kernels/int8_matmul.py gemm_plan): swap = 1 for the
// swapped regime (M <= 256), width = wgmma N, tile_n = the N extent of a
// block's output tile (64 or 128 W rows swapped, 256 otherwise), cluster = blocks splitting K (1, 2, 4 or 8), stages and smem = dynamic
// shared memory bytes.  A plan outside the built kernels is refused with
// cudaErrorInvalidValue.  Returns the launch's error or cudaGetLastError().
extern "C" int int8_matmul_launch(const int8_t* X, const int8_t* W, const float* dx,
                                  const float* dw, void* out, int out_is_bf16, int M,
                                  int N, int K, int swap, int width, int tile_n,
                                  int cluster, int stages, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (encoder() == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const int a_rows = swap ? tile_n : 128;  // rows of a block's A tile
  const bool clus_ok = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8;
  if (K <= 0 || K % 16 || stages < 1 || !clus_ok || (!swap && cluster != 1) ||
      (swap && M > width) || smem < kReserve + stages * (a_rows + width) * KT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
#define INT8_GEMM(NW, WGS, SWAP)                                                      \
  if ((swap != 0) == SWAP && width == NW && tile_n == (SWAP ? 64 * WGS : NW))                \
    e = launch<NW, WGS, SWAP>(X, W, dx, dw, out, out_is_bf16, M, N, K, cluster, stages, \
                              smem, st);
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
