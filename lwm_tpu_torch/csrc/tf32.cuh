// fp32 products on the tensor cores as three TF32 products (CUTLASS's
// "3xTF32"), shared by the fp32 routes of K1 (flash_fwd_f32.cu) and of the
// fused backward (flash_bwd_f32.cu).
//
// Every fp32 operand x is split into hi = x rounded to TF32 (to nearest,
// ties away: `cvt.rna.tf32.f32`'s rounding) and lo = x − hi rounded the same
// way, and a·b is taken as hi·hi + lo·hi + hi·lo (the backward adds lo·lo
// to its sums over every query). The dropped lo·lo and lo's rounding leave
// ~2^-22 of |a·b|, an fp32 product's error. hi is rounded
// explicitly because the tensor cores read an fp32 bit pattern as TF32 by
// dropping its low 13 bits: lo must be taken from the hi that the product
// sees. The tensor cores' fp32 sums lose more than a rounding each, so the
// routes sum hi·hi apart from the small cross terms, or start each tile's
// sum from zero, cross terms first, and add it to the running sum by an FMA.
//
// Tiles of fp32 in shared memory: a tile of R rows × D floats is D / 32
// column groups of R rows × 128 bytes, 128-byte swizzled (16-byte chunk c of
// row r at c ^ (r % 8)), the layout `wgmma` reads K-major; swz32 gives the
// byte offset of a float.

#pragma once

#include "hopper.cuh"

namespace lwm {

// byte offset of float (r, c) in an R-row tile
template <int R>
__device__ __forceinline__ int swz32(int r, int c) {
  return (c >> 5) * R * 128 + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// x rounded to TF32: to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds a finite x, on its bits (half a TF32 ulp added to the magnitude,
// the low 13 bits cleared): 2 instructions where the cvt takes 5 with its
// NaN test (PERF.md §6)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo + O(2^-22 |x|), both TF32 bit patterns
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split4(const float4 x, float4& hi, float4& lo) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                   __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
}

// d[64 × 32] (+)= A (64 × 8) · B (8 × 32), TF32, both K-major in shared
// memory; scale_d 0 ignores d's old value
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 × N] (+)= A (64 × 8: four TF32 registers a thread) · B (8 × N,
// K-major in shared memory), N = 32, 64 or 128. A's registers a0..a3 of a
// thread of warp w (of its warpgroup) are A's (16w + g8, t4), (16w + g8 +
// 8, t4), (16w + g8, t4 + 4), (16w + g8 + 8, t4 + 4): the accumulator's
// elements 4j + (0, 2, 1, 3) once its columns 8j .. 8j + 7 are taken as k
// in the order (0, 2, 4, 6, 1, 3, 5, 7)
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " LWM_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : LWM_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " LWM_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : LWM_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

}  // namespace lwm
