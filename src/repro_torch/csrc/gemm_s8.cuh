// The skeleton both s8 GEMMs share (int8_matmul.cu, int4_matmul.cu): the
// dequantization epilogue, the ring of shared-memory stages between one
// producer warp and the consumer warpgroups, the cluster K-split reduction
// through distributed shared memory, and the host side of a launch (TMA
// tensor maps, the dynamic shared-memory attribute, the cluster launch).
//
// Block layout of both kernels: WGS consumer warpgroups (threads 0 ..
// 128*WGS-1), each owning a 64-row slice of the block's A tile and the
// wgmma accumulators of its 64 x NW output slice, then one producer warp.
// Shared memory: a 1024-byte head for the mbarriers, then `stages` ring
// stages, 1024-aligned (the 128-byte swizzle needs it).  When K is split
// across a cluster, each consumer thread's accumulators are written over the
// drained ring and summed by the cluster's blocks (finish below), so a GEMM
// is one launch: no workspace, no atomics, no second kernel.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "wgmma_s8.cuh"

namespace {

constexpr int KT = 128;         // K values per ring stage
constexpr int kReserve = 2048;  // alignment slack + barriers, before the stages
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Y[m,n] = (float(acc) * dx[m]) * dw[n], IEEE rounding in that order, as the
// plain versions (kernels/int8_matmul.py int8_matmul_ref) compute it.
__device__ __forceinline__ float dequant(int acc, float dx, float dw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), dx), dw);
}

// The ring: full[s] completes when stage s holds step t's tiles (t % stages
// == s), empty[s] when every consumer warp is done with them.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint8_t* tiles;
  int stages;

  __device__ explicit Ring(uint8_t* smem_raw, int n) : stages(n) {
    uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    full = reinterpret_cast<uint64_t*>(base);
    empty = full + n;
    tiles = base + 1024;
  }
  // thread 0, before a __syncthreads(): `producers` arrivals fill a stage
  // (1 with TMA's byte count), `consumers` (lane 0 of every consumer warp)
  // free it
  __device__ void init(uint32_t producers, uint32_t consumers) const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], producers);
      mbar_init(&empty[s], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __device__ uint8_t* stage(int t, int bytes) const { return tiles + (t % stages) * bytes; }
  __device__ uint64_t* full_bar(int t) const { return &full[t % stages]; }
  // producer: wait until step t's stage is free (its previous use released)
  __device__ void wait_empty(int t) const {
    if (t >= stages) mbar_wait(&empty[t % stages], (t / stages - 1) & 1);
  }
  // consumer: wait until step t's tiles have landed
  __device__ void wait_full(int t) const { mbar_wait(&full[t % stages], (t / stages) & 1); }
  __device__ void release(int t) const { mbar_arrive(&empty[t % stages]); }
};

// One output element from its exact int32 sum: row a of the block's A tile
// and column b of its B tile are Y's (m, n), or (n, m) with swapped operands.
// The int4 kernel sums 16*w products, so its sum is shifted back by SHIFT = 4
// (exact: a multiple of 16).  The pointers are the kernel's __restrict__
// parameters, so the scale loads may be scheduled past the output stores.
template <bool SWAP, int SHIFT>
__device__ __forceinline__ void emit(const float* __restrict__ dx,
                                     const float* __restrict__ dw, void* __restrict__ out,
                                     int out_bf16, int M, int N, int ar, int bc,
                                     uint32_t acc) {
  const int m = SWAP ? bc : ar, n = SWAP ? ar : bc;
  if (m < M && n < N) {
    const float y = dequant(static_cast<int>(acc) >> SHIFT, dx[m], dw[n]);
    const int64_t i = static_cast<int64_t>(m) * N + n;
    if (out_bf16)
      store(static_cast<__nv_bfloat16*>(out) + i, y);
    else
      store(static_cast<float*>(out) + i, y);
  }
}

// The K split's exchange across a cluster, by every thread of the block
// (the cluster barriers need all of them; `consumer`: the threads that hold
// sums, each past its last product, so the ring is drained).  They store
// their accumulators over the ring; after a cluster barrier each block sums
// its share of the 8-column blocks from every block's shared memory, in rank
// order, and hands each sum to put(j, v, sum) (column block j, fragment v);
// a second barrier keeps every block alive until the others have read it.
// Integer sums are exact, so the result does not depend on the split.
template <int R, int CONSUMERS, class Put>
__device__ __forceinline__ void cluster_sum(const uint32_t (&acc)[R], uint8_t* tiles,
                                            int cluster, int rank, bool consumer, Put put) {
  uint32_t* part = reinterpret_cast<uint32_t*>(tiles);
  if (consumer) {
#pragma unroll
    for (int i = 0; i < R; ++i) part[i * CONSUMERS + threadIdx.x] = acc[i];
  }
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  cl.sync();  // every block's partial sums are in its shared memory
  if (consumer) {
    const int j0 = rank * (R / 4) / cluster, j1 = (rank + 1) * (R / 4) / cluster;
    for (int j = j0; j < j1; ++j)
      for (int v = 0; v < 4; ++v) {
        const int i = (4 * j + v) * CONSUMERS + threadIdx.x;
        uint32_t sum = 0;
        for (int c = 0; c < cluster; ++c) sum += cl.map_shared_rank(part, c)[i];
        put(j, v, sum);
      }
  }
  cl.sync();  // no block leaves while another still reads its shared memory
}

// After the main loop, by every thread of the block (the cluster barriers
// need all of them).  Without a K split the consumers write their tile;
// with one (cluster > 1), the cluster sums it (cluster_sum).
template <int NW, int WGS, bool SWAP, int SHIFT>
__device__ __forceinline__ void finish(uint32_t (&acc)[NW / 2], uint8_t* tiles, int cluster,
                                       int rank, int a0, int b0,
                                       const float* __restrict__ dx,
                                       const float* __restrict__ dw, void* __restrict__ out,
                                       int out_bf16, int M, int N) {
  constexpr int R = NW / 2, CONSUMERS = WGS * 128;
  const bool consumer = threadIdx.x < CONSUMERS;
  const int lane = threadIdx.x & 31;
  const int row = threadIdx.x / 128 * 64 + (threadIdx.x / 32 % 4) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  if (cluster == 1) {
    if (consumer) {
#pragma unroll
      for (int j = 0; j < R / 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          emit<SWAP, SHIFT>(dx, dw, out, out_bf16, M, N, a0 + row + 8 * (v >> 1),
                            b0 + 8 * j + col + (v & 1), acc[4 * j + v]);
    }
    return;
  }
  // every consumer warp is past its last product: the ring may be reused
  if (consumer) asm volatile("bar.sync 1, %0;\n" ::"r"(CONSUMERS) : "memory");
  cluster_sum<R, CONSUMERS>(acc, tiles, cluster, rank, consumer,
                            [&](int j, int v, uint32_t sum) {
                              emit<SWAP, SHIFT>(dx, dw, out, out_bf16, M, N,
                                                a0 + row + 8 * (v >> 1),
                                                b0 + 8 * j + col + (v & 1), sum);
                            });
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

// The (rows, row_bytes) byte matrix at `p`, rows contiguous, in boxes of
// box_rows rows by box_bytes bytes with the given swizzle; zero fill outside.
bool tensor_map(CUtensorMap* map, const void* p, int rows, int row_bytes, int box_rows,
                int box_bytes, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims,
                   strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches `kern` on a (cluster, 1, 1) cluster grid with `smem` bytes of
// dynamic shared memory.  `smem_set` is the kernel's own record of the largest
// size allowed so far per device (the attribute is set on the current device
// only).
template <typename... Params, typename... Args>
cudaError_t launch_gemm(void (*kern)(Params...), int (&smem_set)[kMaxDevices], dim3 grid,
                        int threads, int smem, int cluster, cudaStream_t st,
                        Args... args) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

// A plan's cluster size: 1, 2, 4 or 8 blocks splitting K.
inline bool cluster_ok(int cluster) {
  return cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8;
}

}  // namespace
