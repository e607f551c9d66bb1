// bf16 products on the tensor cores with float32 accumulation
// (mma.sync m16n8k16), and the ldmatrix loads that feed its fragments from
// shared memory. Used by csrc/conv_gn_mish_bf16.cu (B1's bf16 form) and
// csrc/conv1d_weight_grad_bf16.cu (B2's bf16 form: ldmatrix alone). A
// product of two bf16 values is exact in float32, so c += a b equals the
// float32 sum of the exact products up to the order of the additions.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix on shared addresses: four 8x8 b16 matrices; lane l gives the
// 16-byte row address of row l % 8 of matrix l / 8. As the A fragment of
// m16n8k16 (row-major 16 x 16): lane l points at row (l % 8) + 8 ((l / 8) &
// 1), column 8 (l / 16).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed: B fragments of two n8 tiles from a
// k-major (k rows, n contiguous) layout. Lane l points at k row (l % 8) +
// 8 ((l / 8) & 1), column n0 + 8 (l / 16); r[0..1] is n tile 0, r[2..3] n tile 1.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// B fragment of one n8 tile (k rows 0-7 and 8-15, from lanes 0-15's row addresses).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* row) {
  ldsm_x4_trans(r, smem_u32(row));
}

// c += a b on the tensor cores: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
