// Hopper building blocks for csrc/conv_gn_mish_bf16.cu and
// csrc/conv1d_weight_grad_bf16.cu: swizzled shared-memory
// offsets, mbarriers, TMA tile loads and warpgroup bf16 products (wgmma) with
// A from registers and B from shared memory.
//
// B operands are "MN-major" atoms: rows of S bytes (S = 2 n for an n-wide
// product, n in 8..64), N contiguous, one row per reduction index, eight rows
// a 16-byte swizzle period (S 16: no swizzle). Each wgmma reads one atom, so
// its descriptor needs one stride, the eight-row step of 8 S bytes; it is
// given as both the leading and the stride byte offset.
#pragma once

#include <cuda.h>  // CUtensorMap (the type alone: no -lcuda)
#include <stdint.h>

#include "mma_bf16.h"

// The 16-byte piece of byte offset o in rows of S bytes, as TMA's
// CU_TENSOR_MAP_SWIZZLE_{32,64,128}B place it (S 16: unswizzled): bits 4.. of
// the offset XOR bits 7.., over log2(S / 16) bits. The region must start on a
// 1024-byte boundary.
__host__ __device__ __forceinline__ uint32_t swz(uint32_t o, uint32_t S) {
  return o ^ ((o >> 3) & (S - 16));
}

// -- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and the cluster.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// One arrival that also expects `bytes` more of TMA transfers before the phase ends.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}\n" ::"r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed. A wait that outlasts
// 2^24 polls (far beyond any chunk's transfer) traps: a lost arrival fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 24)) __trap();
}

// -- TMA --------------------------------------------------------------------

// A 3-D box of `map` at (c0, c1, c2) (innermost first; out-of-bounds elements
// are zero-filled) into shared memory at dst, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Orders this thread's generic shared-memory writes before later async-proxy
// (wgmma, TMA) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier over the first `threads` threads of the block (id 1; 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// -- wgmma ------------------------------------------------------------------

// The descriptor of a B atom at shared address `addr` (1024-byte aligned at
// its swizzle period) with rows of S bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t S) {
  const uint64_t step = (8 * S) >> 4;  // eight rows, in 16-byte units
  const uint64_t mode = S == 128 ? 1 : S == 64 ? 2 : S == 32 ? 3 : 0;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (step << 16) | (step << 32) | (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of v across the asynchronous
// product that uses it (place after wgmma_wait).
__device__ __forceinline__ void reg_fence(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& v) { asm volatile("" : "+r"(v)::"memory"); }

// d (64 x n, f32; this thread's n / 2 values) += A (64 x 16 bf16: this warp's
// 16 rows as the m16n8k16 A fragment) x B (16 x n bf16, MN-major atom at desc_b).
__device__ __forceinline__ void wgmma_m64n8k16(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n16k16(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n32k16(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// One n-wide product (n in 8, 16, 32, 64) chosen at compile time.
template <int kN>
__device__ __forceinline__ void wgmma_m64k16(float* d, const uint32_t* a, uint64_t desc_b) {
  static_assert(kN == 8 || kN == 16 || kN == 32 || kN == 64, "wgmma atom width");
  if constexpr (kN == 8) wgmma_m64n8k16(d, a, desc_b);
  if constexpr (kN == 16) wgmma_m64n16k16(d, a, desc_b);
  if constexpr (kN == 32) wgmma_m64n32k16(d, a, desc_b);
  if constexpr (kN == 64) wgmma_m64n64k16(d, a, desc_b);
}
