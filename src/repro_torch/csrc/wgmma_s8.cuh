// Hopper building blocks of the s8 GEMMs (int8_matmul.cu, int4_matmul.cu,
// int8_batched.cu):
// mbarrier waits, TMA tile loads, the shared-memory matrix descriptor of a
// K-major tile written by TMA with 128-byte swizzle, and the s8 warpgroup
// product wgmma.mma_async.m64nNk32.s32.s8.s8 (int32 accumulators in
// registers), one wrapper per width N that the launch plans use
// (kernels/int8_matmul.py WIDTHS and TILED_WIDTHS; the PTX ISA allows 8,
// 16, 24, 32 and multiples of 16 up to 256 for s8), with A from shared
// memory (mma) or from registers (mma_rs).
//
// Accumulator layout of m64nN (each of the 128 threads of the warpgroup
// holds N/2 values): thread t = 32*w + l holds, for every 8-column block j,
// d[4j + v] = D[16w + l/4 + 8*(v/2)][8j + 2*(l%4) + v%2].
//
// Register A fragment of m64nNk32 for s8 (four registers of four K-consecutive
// bytes): thread t = 32*w + l holds a[i] = A[16w + l/4 + 8*(i%2)][4*(l%4) +
// 16*(i/2) .. +3], the layout of mma.sync.m16n8k32 per warp.
#pragma once

#include <cuda.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

// Arrives once and adds `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Orders this thread's ordinary (generic-proxy) writes to shared memory
// before later async-proxy reads of the same bytes, such as a wgmma operand.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One TMA load of the box at (c0 = inner coordinate, c1 = row) of `map` into
// shared memory; completion is counted in bytes on `bar`.  Parts of the box
// outside the tensor are zero-filled and still counted.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Descriptor of a K-major operand tile whose rows are 128 bytes, written by
// TMA with CU_TENSOR_MAP_SWIZZLE_128B at a 1024-byte-aligned base: groups of
// 8 rows are 1024 bytes apart (stride byte offset); the leading byte offset
// is unused with this swizzle.  `p` may point 32, 64 or 96 bytes into the
// rows to select the k32 slice: the swizzle is applied to the address.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// an asynchronous product that is still in flight.
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x N, int32) += A (64 x 32 s8, K-major) * B (N x 32 s8, K-major)^T,
// B from shared memory through its descriptor, A through its descriptor
// (Wgmma<N>::mma) or from the four fragment registers above
// (Wgmma<N>::mma_rs).  Both take the N/2 accumulators of a thread; one
// specialisation per width the plans use, each written by WGMMA_S8 from one
// list of operand names.
template <int N>
struct Wgmma;

// "%0, %1, ..., %R-1": the R accumulator operands of the asm template.
#define WG_REGS_4 "%0, %1, %2, %3"
#define WG_REGS_12 WG_REGS_4 ", %4, %5, %6, %7, %8, %9, %10, %11"
#define WG_REGS_24 WG_REGS_12 ", %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
#define WG_REGS_48                                                                  \
  WG_REGS_24 ", %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, " \
             "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define WG_REGS_88                                                                     \
  WG_REGS_48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "    \
             "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, " \
             "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87"
#define WG_REGS_96                                                                     \
  WG_REGS_48 ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "    \
             "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, " \
             "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, " \
             "%92, %93, %94, %95"
#define WG_REGS_128                                                                     \
  WG_REGS_96 ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "      \
             "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "  \
             "%120, %121, %122, %123, %124, %125, %126, %127"
// The matching read-write register operands d[0] ... d[R-1].
#define WG_D4(j) "+r"(d[4 * (j)]), "+r"(d[4 * (j) + 1]), "+r"(d[4 * (j) + 2]), "+r"(d[4 * (j) + 3])
#define WG_D12(j) WG_D4(3 * (j)), WG_D4(3 * (j) + 1), WG_D4(3 * (j) + 2)
#define WG_OPS_4 WG_D4(0)
#define WG_OPS_12 WG_D12(0)
#define WG_OPS_24 WG_D12(0), WG_D12(1)
#define WG_OPS_48 WG_OPS_24, WG_D12(2), WG_D12(3)
#define WG_OPS_88 WG_OPS_48, WG_D12(4), WG_D12(5), WG_D12(6), WG_D4(21)
#define WG_OPS_96 WG_OPS_48, WG_D12(4), WG_D12(5), WG_D12(6), WG_D12(7)
#define WG_OPS_128 WG_OPS_96, WG_D12(8), WG_D12(9), WG_D4(30), WG_D4(31)

// N: the width; R = N/2 accumulators; A, B, P: the operand numbers R, R+1
// and R+2 of the two descriptors and the scale-d flag of mma; A0..A3, RB,
// RP: the operand numbers R .. R+5 of mma_rs's four A registers, its B
// descriptor and its flag.
#define WGMMA_S8(N, R, A, B, P, A0, A1, A2, A3, RB, RP)                                 \
  template <>                                                                         \
  struct Wgmma<N> {                                                                   \
    static __device__ __forceinline__ void mma(uint32_t (&d)[R], uint64_t a,          \
                                               uint64_t b) {                          \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                    \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 {" WG_REGS_##R   \
                   "}, %" #A ", %" #B ", p;\n}\n"                                      \
                   : WG_OPS_##R                                                       \
                   : "l"(a), "l"(b), "r"(1));                                         \
    }                                                                                 \
    static __device__ __forceinline__ void mma_rs(uint32_t (&d)[R],                   \
                                                  const uint32_t (&a)[4], uint64_t b) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #RP ", 0;\n"                   \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 {" WG_REGS_##R   \
                   "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #RB ", p;\n}\n"      \
                   : WG_OPS_##R                                                       \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));     \
    }                                                                                 \
  };

WGMMA_S8(8, 4, 4, 5, 6, 4, 5, 6, 7, 8, 9)
WGMMA_S8(24, 12, 12, 13, 14, 12, 13, 14, 15, 16, 17)
WGMMA_S8(48, 24, 24, 25, 26, 24, 25, 26, 27, 28, 29)
WGMMA_S8(96, 48, 48, 49, 50, 48, 49, 50, 51, 52, 53)
WGMMA_S8(176, 88, 88, 89, 90, 88, 89, 90, 91, 92, 93)
WGMMA_S8(192, 96, 96, 97, 98, 96, 97, 98, 99, 100, 101)
WGMMA_S8(256, 128, 128, 129, 130, 128, 129, 130, 131, 132, 133)

#undef WGMMA_S8
#undef WG_OPS_128
#undef WG_OPS_96
#undef WG_OPS_88
#undef WG_OPS_48
#undef WG_OPS_24
#undef WG_OPS_12
#undef WG_OPS_4
#undef WG_D12
#undef WG_D4
#undef WG_REGS_128
#undef WG_REGS_96
#undef WG_REGS_88
#undef WG_REGS_48
#undef WG_REGS_24
#undef WG_REGS_12
#undef WG_REGS_4

}  // namespace
