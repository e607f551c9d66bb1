// float32 products on the tensor cores at about float32 accuracy (3xTF32),
// shared by csrc/local_attention.cu (B3, B4) and csrc/conv1d_weight_grad.cu
// (B2). Each operand is split into a TF32 high part and a TF32 remainder;
// three m16n8k8 products (lo*hi, hi*lo, hi*hi) keep about 21 bits of each.
#pragma once

#include <stdint.h>

// x as a tf32 pair: hi = tf32(x), lo = tf32(x - hi); hi * y + lo * y keeps
// about 21 bits of x (3xTF32).
__device__ __forceinline__ void split_tf32(float x, uint32_t* hi, uint32_t* lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(*hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(*lo) : "f"(x - __uint_as_float(*hi)));
}

// The same split by truncation: hi = x with its 13 low mantissa bits
// cleared, lo = x - hi (exact), passed whole, since the tensor cores read
// the top 19 bits of a tf32 operand and drop the rest. Two instructions
// where cvt.rna takes several; x keeps about 20 bits, as above.
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t* hi, uint32_t* lo) {
  *hi = __float_as_uint(x) & 0xffffe000u;
  *lo = __float_as_uint(x - __uint_as_float(*hi));
}

// c += a b on the tensor cores, m16n8k8, tf32 in, f32 out
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b to about f32 accuracy: a and b given as (hi, lo) tf32 pairs, the
// small products first
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* a_hi, const uint32_t* a_lo,
                                           const uint32_t* b_hi, const uint32_t* b_lo) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}
