// W8A8 batched expert GEMM: X (E, C, K) int8 times W (E, N, K) int8 with
// int32 accumulation and the dequantization epilogue
// Y[e,m,n] = (float(acc) * dx[e,m]) * dw[e,n], written as bf16 or f32, and
// +0 for every row m at or past expert e's fill rows[e] (its kept slots).
//
// Replaces no Pallas kernel: the W8A8 branch of the reference's MoE expert
// product (repro/models/moe.py:72-87 _expert_linear) is a jnp dot_general
// over experts.  torch has no batched int8 product with int32 sums on CUDA.
//
// Why the zero rows change no bit of the layer: MoE.forward gathers the
// zero row into every slot past an expert's fill; it quantizes to codes 0,
// so the reference's product there is +0 wherever dw is finite, and the
// combine reads only rows inside the fill.  So the rows past the fill are
// written +0 without loading X or W for them, and an expert with no kept
// slot reads no W at all.
//
// Bound on the H100 (3.35 TB/s, 1979 int8 TOPS), moonshot (E 64, 2048 <->
// 1408): decode (C 3) and paged admission (C 120) are bytes: every kept
// expert's W once (184.5 MB with all 64: 0.055 ms); prefill (C 480) is
// near the ridge: 334 MB (0.100 ms) against 177 G operations (0.089 ms).
//
// Design: a persistent grid.  Each block builds, from rows, the list of
// (expert, tile) items of the experts that keep a slot, in expert order
// (build_items: a warp's prefix sum into shared memory), and walks every
// gridDim-th item.  One producer warp streams each item's K steps through a
// ring of TMA stages (128-byte swizzle, zero fill past the tensors); the
// ring's counter runs on across items, so the next item's stages land while
// the consumer warpgroups store the current one.  An item's scales are
// copied to shared memory (cp.async) when it starts, so its epilogue reads
// no device memory.  The rows past the live items' rows (an expert with no
// kept slot, or M tiles wholly past the fill) are zeroed after the walk.
// Integer sums are exact and order-free, so the bits depend on no tiling,
// split or walk.  Two regimes, chosen from C by the plan
// (kernels/int8_matmul.py batched_plan; the tiled one ran faster from C 64
// on):
// - C <= 48, swapped: an item is one expert's tile of 64 W rows, wgmma's
//   A, times all C rows of the expert's X, its N (C rounded up to a built
//   width: 8, 24, 48), as int8_matmul.cu's swapped regime, up to three
//   blocks per SM.  Where the experts' tiles leave the card idle (few
//   experts), K is split across a cluster of up to 8 blocks, one item per
//   cluster, the int32 sums reduced through distributed shared memory over
//   the drained ring.
// - C > 48, tiled: an item is a 128-row M tile of one expert times one N
//   tile of the expert's own width where a built width divides it (176 at
//   1408, 256 at 2048), so no column reads the next expert's W; X is
//   wgmma's A (64 rows per consumer warpgroup), W its B.  The bf16 tile is
//   staged in shared memory and stored in 16-byte chunks of whole rows.  (A
//   cluster of M tiles sharing each W stage by TMA multicast was built,
//   held bit-equal, and ran 2-20% slower at moonshot's prefill: PERF.md
//   §6, the batched expert GEMM's redesign.)
#include "gemm_s8.cuh"

#ifndef GEMM_TRACE
#define TRACE(slot)
#endif

namespace {

constexpr int kMaxExperts = 256;
constexpr int kTileM = 128;  // X rows of a tiled item: two consumer warpgroups

// Item i of block b's walk writes its timestamps at 2 + 4i .. 5 + 4i
// (tools/batched_gemm_trace.py); 126 and 127 are the walk's and the
// block's end.
#define TRACE_ITEM(j, p) TRACE(((j) - cid) / ncl < 31 ? 2 + 4 * (((j) - cid) / ncl) + (p) : 128)

// Copies the float at src to shared memory at dst without holding a
// register (zero when !pred), in the thread's current cp.async group.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// An item's scales into shared memory, by `threads` threads from `tid`:
// dx of rows m0 .. m0 + rows - 1 (zero at and past the fill, none read
// there) and dw of columns n0 .. n0 + cols - 1 (zero past N).  Issued when
// the item starts, waited for before its epilogue.
__device__ __forceinline__ void prefetch_scales(const float* __restrict__ dx,
                                                const float* __restrict__ dw, int e, int C,
                                                int N, int fill, int m0, int rows, int n0,
                                                int cols, float* s_dx, float* s_dw, int tid,
                                                int threads) {
  for (int i = tid; i < rows + cols; i += threads) {
    if (i < rows) {
      const bool ok = m0 + i < fill;
      cp_async4(s_dx + i, dx + static_cast<int64_t>(e) * C + (ok ? m0 + i : 0), ok);
    } else {
      const bool ok = n0 + i - rows < N;
      cp_async4(s_dw + i - rows, dw + static_cast<int64_t>(e) * N + (ok ? n0 + i - rows : 0),
                ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The walk's items, by warp 0 into shared memory, then a block barrier:
// fill[e] = rows[e] clamped to [0, C] (C where rows is null); expert e's
// items are ceil(fill[e] / group_rows) row groups times per_group tiles;
// start[e] counts the items of experts 0 .. e-1, start[E] them all.
__device__ void build_items(const int* __restrict__ rows, int E, int C, int group_rows,
                            int per_group, int* start, int* fill) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      int n = 0;
      if (e < E) {
        const int f = rows == nullptr ? C : min(max(rows[e], 0), C);
        fill[e] = f;
        n = (f + group_rows - 1) / group_rows * per_group;
      }
      int incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (e < E) start[e] = base + incl - n;
      base += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) start[E] = base;
  }
  __syncthreads();
}

// The expert of item j < start[E]: the last e with start[e] <= j.
__device__ __forceinline__ int item_expert(const int* start, int E, int j) {
  int lo = 0, hi = E;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (start[mid] <= j) lo = mid;
    else hi = mid;
  }
  return lo;
}

// Zeroes bytes [b0, b1) with the block's threads (both ends even: the
// elements are 2 or 4 bytes), 16 bytes a store between 16-byte boundaries.
__device__ void zero_bytes(uint8_t* b0, uint8_t* b1) {
  const uintptr_t mask = ~uintptr_t(15);
  uint8_t* a0 = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(b0) + 15) & mask);
  uint8_t* a1 = reinterpret_cast<uint8_t*>(reinterpret_cast<uintptr_t>(b1) & mask);
  if (a0 > b1) a0 = b1;
  if (a1 < a0) a1 = a0;
  for (uint8_t* p = b0 + 2 * threadIdx.x; p < a0; p += 2 * blockDim.x)
    *reinterpret_cast<uint16_t*>(p) = 0;
  for (uint8_t* p = a0 + 16 * threadIdx.x; p < a1; p += 16 * blockDim.x)
    *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
  for (uint8_t* p = a1 + 2 * threadIdx.x; p < b1; p += 2 * blockDim.x)
    *reinterpret_cast<uint16_t*>(p) = 0;
}

// After the walk: rows [z, C) of each expert whose live items stop at row z
// < C (z = its live row groups times group_rows), one expert per block.
__device__ void zero_rest(const int* start, int E, int C, int N, int group_rows,
                          int per_group, void* __restrict__ out, int esize) {
  for (int e = blockIdx.x; e < E; e += gridDim.x) {
    const int z = min(C, (start[e + 1] - start[e]) / per_group * group_rows);
    if (z >= C) continue;
    uint8_t* base = static_cast<uint8_t*>(out);
    zero_bytes(base + (static_cast<int64_t>(e) * C + z) * N * esize,
               base + (static_cast<int64_t>(e) + 1) * C * N * esize);
  }
}

__device__ __forceinline__ void put(void* __restrict__ out, int out_bf16, int64_t i, float y) {
  if (out_bf16)
    store(static_cast<__nv_bfloat16*>(out) + i, y);
  else
    store(static_cast<float*>(out) + i, y);
}

// ---------------------------------------------------------------------------
// Swapped regime (C <= 48)
// ---------------------------------------------------------------------------

// One output element of a swapped tile: row a of the W tile is n, column b
// of the X tile is m; the item's scales in shared memory (s_dw from n0).
__device__ __forceinline__ void emit_swapped(const float* s_dx, const float* s_dw,
                                             void* __restrict__ out, int out_bf16, int e,
                                             int C, int N, int fill, int n0, int n, int m,
                                             uint32_t acc) {
  if (m < C && n < N)
    put(out, out_bf16, (static_cast<int64_t>(e) * C + m) * N + n,
        m < fill ? dequant(static_cast<int>(acc), s_dx[m], s_dw[n - n0]) : 0.0f);
}

template <int NW>
__global__ void __launch_bounds__(128 + 32, 2)
batched_swap_kernel(const __grid_constant__ CUtensorMap tmW,
                    const __grid_constant__ CUtensorMap tmX, const float* __restrict__ dx,
                    const float* __restrict__ dw, const int* __restrict__ rows,
                    void* __restrict__ out, int out_bf16, int E, int C, int N, int ktiles,
                    int kt_per_split, int stages, int cluster, int tiles) {
  constexpr int A_ROWS = 64, A_BYTES = A_ROWS * KT, STAGE = A_BYTES + NW * KT;
  constexpr int CONSUMERS = 128, R = NW / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_start[kMaxExperts + 1], s_fill[kMaxExperts];
  __shared__ float s_dx[2][256], s_dw[2][128];  // an item's scales, by item parity
  const Ring ring(smem_raw, stages);
  TRACE(0)
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  const int rank = blockIdx.x % cluster, cid = blockIdx.x / cluster, ncl = gridDim.x / cluster;
  // this rank's K tiles [kt0, kt0 + nk)
  const int kt0 = rank * kt_per_split;
  const int nk = max(0, min(ktiles, kt0 + kt_per_split) - kt0);
  if (threadIdx.x == 0) ring.init(1, 4);
  // an item is a whole expert's C rows times one W tile
  build_items(rows, E, C, C, tiles, s_start, s_fill);
  TRACE(1)
  const int total = s_start[E];
  const int row = (threadIdx.x / 32 % 4) * 16 + lane / 4, col = 2 * (lane % 4);

  if (wg == 1) {
    // producer warp: one thread streams every item's K steps
    if (threadIdx.x == CONSUMERS) {
      int t = 0;
      for (int j = cid; j < total; j += ncl) {
        const int e = item_expert(s_start, E, j);
        const int a_row = e * N + (j - s_start[e]) * A_ROWS, b_row = e * C;
        for (int i = 0; i < nk; ++i, ++t) {
          ring.wait_empty(t);
          uint8_t* st = ring.stage(t, STAGE);
          const int k = (kt0 + i) * KT;
          mbar_expect_tx(ring.full_bar(t), STAGE);
          tma_load_2d(st, &tmW, ring.full_bar(t), k, a_row);
          tma_load_2d(st + A_BYTES, &tmX, ring.full_bar(t), k, b_row);
        }
      }
    }
    __syncwarp();
    if (cluster > 1 && cid < total) {  // the two barriers of the consumers' cluster_sum
      cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
      cl.sync();
      cl.sync();
    }
  } else {
    uint32_t acc[R];
    int t = 0;
    for (int j = cid; j < total; j += ncl) {
      TRACE_ITEM(j, 0)
      const int e = item_expert(s_start, E, j), buf = (j - cid) / ncl & 1;
      const int n0 = (j - s_start[e]) * A_ROWS;
      prefetch_scales(dx, dw, e, C, N, s_fill[e], 0, C, n0, A_ROWS, s_dx[buf], s_dw[buf],
                      threadIdx.x, CONSUMERS);
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = 0;
      for (int i = 0; i < nk; ++i, ++t) {
        ring.wait_full(t);
        if (i == 0) { TRACE_ITEM(j, 1) }
        const uint8_t* a = ring.stage(t, STAGE);
        const uint8_t* b = a + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT; kk += 32)
          Wgmma<NW>::mma(acc, sw128_desc(a + kk), sw128_desc(b + kk));
        wgmma_commit();
        wgmma_wait<1>();  // the products of step t-1 are done: release it
        fence_regs(acc);
        if (i > 0 && lane == 0) ring.release(t - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (nk > 0 && lane == 0) ring.release(t - 1);
      TRACE_ITEM(j, 2)
      cp_async_wait_all();
      asm volatile("bar.sync 1, %0;\n" ::"r"(CONSUMERS) : "memory");  // every scale landed
      if (cluster == 1) {
        const int fill = s_fill[e];
#pragma unroll
        for (int q = 0; q < R / 4; ++q)
#pragma unroll
          for (int v = 0; v < 4; ++v)
            emit_swapped(s_dx[buf], s_dw[buf], out, out_bf16, e, C, N, fill, n0,
                         n0 + row + 8 * (v >> 1), 8 * q + col + (v & 1), acc[4 * q + v]);
      }
      TRACE_ITEM(j, 3)
    }
    if (cluster > 1 && cid < total) {
      // K split: one item per cluster (the plan's grid), so the ring is
      // drained (every consumer is past the barrier after its last product)
      const int e = item_expert(s_start, E, cid);
      const int n0 = (cid - s_start[e]) * A_ROWS, fill = s_fill[e];
      cluster_sum<R, CONSUMERS>(acc, ring.tiles, cluster, rank, true,
                                [&](int q, int v, uint32_t sum) {
                                  emit_swapped(s_dx[0], s_dw[0], out, out_bf16, e, C, N,
                                               fill, n0, n0 + row + 8 * (v >> 1),
                                               8 * q + col + (v & 1), sum);
                                });
    }
  }
  TRACE(126)
  zero_rest(s_start, E, C, N, C, tiles, out, out_bf16 ? 2 : 4);
  TRACE(127)
}

// ---------------------------------------------------------------------------
// Tiled regime (C > 48)
// ---------------------------------------------------------------------------

template <int BN>
__global__ void __launch_bounds__(2 * 128 + 32, 1)
batched_tiled_kernel(const __grid_constant__ CUtensorMap tmX,
                     const __grid_constant__ CUtensorMap tmW, const float* __restrict__ dx,
                     const float* __restrict__ dw, const int* __restrict__ rows,
                     void* __restrict__ out, int out_bf16, int E, int C, int N, int ktiles,
                     int stages, int ntn) {
  constexpr int X_BYTES = kTileM * KT, W_BYTES = BN * KT, STAGE = X_BYTES + W_BYTES;
  constexpr int CONSUMERS = 256, R = BN / 2;
  constexpr int PITCH = 2 * BN + 16;  // bytes per staged bf16 row: no bank conflicts
  extern __shared__ uint8_t smem_raw[];
  __shared__ int s_start[kMaxExperts + 1], s_fill[kMaxExperts];
  __shared__ float s_dx[2][kTileM], s_dw[2][256];  // an item's scales, by item parity
  const Ring ring(smem_raw, stages);
  uint8_t* staged = ring.tiles + stages * STAGE;  // the bf16 output tile
  TRACE(0)
  const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) ring.init(1, 8);
  // an item is one 128-row M tile of an expert times one N tile
  build_items(rows, E, C, kTileM, ntn, s_start, s_fill);
  TRACE(1)
  const int total = s_start[E], cid = blockIdx.x, ncl = gridDim.x;

  if (wg == 2) {
    // producer warp: one thread streams each item's X and W tiles
    if (threadIdx.x == CONSUMERS) {
      int t = 0;
      for (int j = cid; j < total; j += ncl) {
        const int e = item_expert(s_start, E, j), local = j - s_start[e];
        const int x_row = e * C + local / ntn * kTileM, w_row = e * N + local % ntn * BN;
        for (int kt = 0; kt < ktiles; ++kt, ++t) {
          ring.wait_empty(t);
          uint8_t* st = ring.stage(t, STAGE);
          mbar_expect_tx(ring.full_bar(t), STAGE);
          tma_load_2d(st, &tmX, ring.full_bar(t), kt * KT, x_row);
          tma_load_2d(st + X_BYTES, &tmW, ring.full_bar(t), kt * KT, w_row);
        }
      }
    }
  } else {
    // both consumer warpgroups on each item: 64 of its 128 rows each
    const int tid = threadIdx.x;
    const int row = wg * 64 + (tid / 32 % 4) * 16 + lane / 4, col = 2 * (lane % 4);
    int t = 0;
    for (int j = cid; j < total; j += ncl) {
      TRACE_ITEM(j, 0)
      const int e = item_expert(s_start, E, j), local = j - s_start[e];
      const int m0 = local / ntn * kTileM, n0 = local % ntn * BN;
      const int fill = s_fill[e], buf = (j - cid) / ncl & 1;
      prefetch_scales(dx, dw, e, C, N, fill, m0, kTileM, n0, BN, s_dx[buf], s_dw[buf], tid,
                      CONSUMERS);
      uint32_t acc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = 0;
      for (int kt = 0; kt < ktiles; ++kt, ++t) {
        ring.wait_full(t);
        if (kt == 0) { TRACE_ITEM(j, 1) }
        const uint8_t* a = ring.stage(t, STAGE) + wg * 64 * KT;
        const uint8_t* b = ring.stage(t, STAGE) + X_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT; kk += 32)
          Wgmma<BN>::mma(acc, sw128_desc(a + kk), sw128_desc(b + kk));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        if (kt > 0 && lane == 0) ring.release(t - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) ring.release(t - 1);
      TRACE_ITEM(j, 2)
      // every scale has landed, and the previous item's stores have read the
      // staged tile
      cp_async_wait_all();
      asm volatile("bar.sync 1, %0;\n" ::"r"(CONSUMERS) : "memory");
      const float* sdx = s_dx[buf];
      const float* sdw = s_dw[buf];
      if (out_bf16) {
        // the tile in shared memory, then whole rows in 16-byte chunks
#pragma unroll
        for (int q = 0; q < R / 4; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row + 8 * h, c = 8 * q + col;
            const uint32_t* p = acc + 4 * q + 2 * h;
            const bool kept = m0 + r < fill;
            const float y0 = kept ? dequant(static_cast<int>(p[0]), sdx[r], sdw[c]) : 0.f;
            const float y1 = kept ? dequant(static_cast<int>(p[1]), sdx[r], sdw[c + 1]) : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(staged + r * PITCH + 2 * c) =
                __halves2bfloat162(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
          }
        asm volatile("bar.sync 1, %0;\n" ::"r"(CONSUMERS) : "memory");
        constexpr int CHUNKS = BN / 8;
        const bool vec = N % 8 == 0;
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
        for (int i = tid; i < kTileM * CHUNKS; i += CONSUMERS) {
          const int r = i / CHUNKS, ch = i % CHUNKS, m = m0 + r, n = n0 + 8 * ch;
          if (m >= C || n >= N) continue;
          const int64_t at = (static_cast<int64_t>(e) * C + m) * N + n;
          const uint8_t* src = staged + r * PITCH + 16 * ch;
          if (vec) {
            *reinterpret_cast<uint4*>(o + at) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (int q = 0; q < 8 && n + q < N; ++q)
              o[at + q] = reinterpret_cast<const __nv_bfloat16*>(src)[q];
          }
        }
        TRACE_ITEM(j, 3)
        continue;
      }
      // f32: from the accumulators (rows past C are the next expert's,
      // columns past N the next expert's or none)
#pragma unroll
      for (int q = 0; q < R / 4; ++q)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = row + 8 * (v >> 1), c = 8 * q + col + (v & 1);
          const int m = m0 + r, n = n0 + c;
          if (m < C && n < N)
            put(out, 0, (static_cast<int64_t>(e) * C + m) * N + n,
                m < fill ? dequant(static_cast<int>(acc[4 * q + v]), sdx[r], sdw[c]) : 0.f);
        }
      TRACE_ITEM(j, 3)
    }
  }
  TRACE(126)
  zero_rest(s_start, E, C, N, kTileM, ntn, out, out_bf16 ? 2 : 4);
  TRACE(127)
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Blocks the card holds at once with `smem` bytes each, per device, from
// the occupancy calculator (kept for the last size asked); the kernel's
// dynamic shared-memory attribute is set first.
template <typename Kern>
int resident(Kern kern, int (&smem_set)[kMaxDevices], int (&held)[kMaxDevices],
             int (&held_smem)[kMaxDevices], int threads, int smem) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (smem > smem_set[dev]) {
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
        cudaSuccess)
      return 0;
    smem_set[dev] = smem;
  }
  if (held_smem[dev] != smem) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    held[dev] = per_sm * sms;
    held_smem[dev] = smem;
  }
  return held[dev];
}

template <int NW>
cudaError_t launch_swap(const int8_t* X, const int8_t* W, const float* dx, const float* dw,
                        const int* rows, void* out, int out_bf16, int E, int C, int N, int K,
                        int cluster, int stages, int smem, int grid, cudaStream_t st) {
  constexpr int A_ROWS = 64, THREADS = 128 + 32;
  if (cluster > 1 && smem < kReserve + 256 * NW)  // the int32 partial sums
    return cudaErrorInvalidValue;
  CUtensorMap mw, mx;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map(&mw, W, E * N, K, A_ROWS, KT, sw) ||
      !tensor_map(&mx, X, E * C, K, NW, KT, sw))
    return cudaErrorInvalidValue;
  auto kern = batched_swap_kernel<NW>;
  static int smem_set[kMaxDevices] = {}, held[kMaxDevices] = {}, held_smem[kMaxDevices] = {};
  const int tiles = (N + A_ROWS - 1) / A_ROWS;
  if (cluster == 1) {
    // a persistent grid: no more blocks than the card holds at once
    const int n = resident(kern, smem_set, held, held_smem, THREADS, smem);
    if (n <= 0) return cudaErrorInvalidConfiguration;
    grid = min(grid, n);
  } else if (grid != E * tiles * cluster) {  // one item per cluster
    return cudaErrorInvalidValue;
  }
  const int ktiles = (K + KT - 1) / KT;
  const int per = (ktiles + cluster - 1) / cluster;
  return launch_gemm(kern, smem_set, dim3(grid, 1, 1), THREADS, smem, cluster, st, mw, mx,
                     dx, dw, rows, out, out_bf16, E, C, N, ktiles, per, stages, cluster,
                     tiles);
}

template <int BN>
cudaError_t launch_tiled(const int8_t* X, const int8_t* W, const float* dx, const float* dw,
                         const int* rows, void* out, int out_bf16, int E, int C, int N, int K,
                         int stages, int smem, int grid, cudaStream_t st) {
  constexpr int THREADS = 2 * 128 + 32;
  if (smem < kReserve + stages * (kTileM + BN) * KT + kTileM * (2 * BN + 16))
    return cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map(&mx, X, E * C, K, kTileM, KT, sw) || !tensor_map(&mw, W, E * N, K, BN, KT, sw))
    return cudaErrorInvalidValue;
  auto kern = batched_tiled_kernel<BN>;
  static int smem_set[kMaxDevices] = {}, held[kMaxDevices] = {}, held_smem[kMaxDevices] = {};
  const int n = resident(kern, smem_set, held, held_smem, THREADS, smem);
  if (n <= 0) return cudaErrorInvalidConfiguration;
  return launch_gemm(kern, smem_set, dim3(min(grid, n), 1, 1), THREADS, smem, 1, st, mx, mw,
                     dx, dw, rows, out, out_bf16, E, C, N, (K + KT - 1) / KT, stages,
                     (N + BN - 1) / BN);
}

}  // namespace

// X: (E, C, K) int8, W: (E, N, K) int8, both K-contiguous and 16-byte
// aligned with K % 16 == 0; dx: (E, C) f32; dw: (E, N) f32; rows: (E,) int32
// kept rows per expert, or null (every row); out: (E, C, N) bf16
// (out_is_bf16 != 0) or f32, 16-byte aligned.  The plan
// (kernels/int8_matmul.py batched_plan): swap = 1 for the swapped regime
// (C <= 256); width = wgmma N (C rounded up to a built width swapped, the N
// tile tiled); tile_n = W rows per item (64 or 128) swapped, the N tile
// tiled; cluster = blocks splitting K (swapped; 1 tiled); stages; smem =
// dynamic shared memory bytes (tiled: the bf16 output tile's too); grid =
// blocks
// at most (fewer where the card holds fewer at once).  A plan outside the
// built kernels is refused with cudaErrorInvalidValue.  Returns the launch's
// error or cudaGetLastError().
extern "C" int int8_batched_launch(const int8_t* X, const int8_t* W, const float* dx,
                                   const float* dw, const int* rows, void* out,
                                   int out_is_bf16, int E, int C, int N, int K, int swap,
                                   int width, int tile_n, int cluster, int stages, int smem,
                                   int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (E > kMaxExperts || static_cast<int64_t>(E) * (C > N ? C : N) > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (encoder() == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  if (K <= 0 || K % 16 || stages < 1 || grid < 1 || cluster < 1 || cluster > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
  if (swap) {
    if (!cluster_ok(cluster) || C > width || smem < kReserve + stages * (tile_n + width) * KT)
      return static_cast<int>(cudaErrorInvalidValue);
    // the plan's swapped widths (C <= 48), one 64-row W tile per item
    if (tile_n != 64) return static_cast<int>(cudaErrorInvalidValue);
    if (width == 8)
      e = launch_swap<8>(X, W, dx, dw, rows, out, out_is_bf16, E, C, N, K, cluster, stages,
                         smem, grid, st);
    if (width == 24)
      e = launch_swap<24>(X, W, dx, dw, rows, out, out_is_bf16, E, C, N, K, cluster, stages,
                          smem, grid, st);
    if (width == 48)
      e = launch_swap<48>(X, W, dx, dw, rows, out, out_is_bf16, E, C, N, K, cluster, stages,
                          smem, grid, st);
  } else {
    if (cluster != 1 || width != tile_n) return static_cast<int>(cudaErrorInvalidValue);
    if (width == 176)
      e = launch_tiled<176>(X, W, dx, dw, rows, out, out_is_bf16, E, C, N, K, stages, smem,
                            grid, st);
    if (width == 256)
      e = launch_tiled<256>(X, W, dx, dw, rows, out, out_is_bf16, E, C, N, K, stages, smem,
                            grid, st);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* int8_batched_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
