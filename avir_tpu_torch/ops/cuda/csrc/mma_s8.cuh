// Building blocks of the s8 tensor-core kernels (fused_int8.cu, fused_ring.cu):
// ldmatrix and mma.sync m16n8k32 s8 x s8 -> s32 (cp.async staging from
// cp_async.cuh), and the requantization of first-pass sums into the
// intermediate's s8 limbs.

#pragma once

#include <cstdint>

#include "cp_async.cuh"
#include "k1_common.cuh"

namespace mma_s8 {

using namespace cp_async;

// Four 8x8 b16 matrices (8 rows of 16 bytes each); thread l names row
// (l & 15) at byte column (l >> 4) * 16 of a [16][32]-byte tile, so r[0..3]
// are its (rows 0-7, bytes 0-15), (8-15, 0-15), (0-7, 16-31), (8-15,
// 16-31) quarters: the A fragment of m16n8k32 s8, or on a [N][K] tile the
// B fragments {r0, r2} of rows 0-7 and {r1, r3} of rows 8-15.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const uint8_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a * b, m16n8k32, s8 operands, s32 accumulators (wrapping).
__device__ __forceinline__ void mma8(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The first-pass sums of two neighbouring elements requantized and split
// into their s8 limbs, two bytes a plane.
__device__ __forceinline__ void limbs2(int32_t fa, int32_t fb, int sh, uint8_t* x1, uint8_t* x0) {
  const int32_t qa = k1::requant(fa, sh), qb = k1::requant(fb, sh);
  const int32_t ha = k1::limb_hi(qa), hb = k1::limb_hi(qb);
  *reinterpret_cast<uint16_t*>(x1) = static_cast<uint16_t>((ha & 0xff) | ((hb & 0xff) << 8));
  *reinterpret_cast<uint16_t*>(x0) =
      static_cast<uint16_t>(((qa - 128 * ha) & 0xff) | (((qb - 128 * hb) & 0xff) << 8));
}

// Four 32-bit words w[e] (4 bytes of row e each) transposed: word i of the
// result holds byte i of w[0..3], i.e. 4 rows of one lane.
__device__ __forceinline__ uint4 transpose4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3) {
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
  const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
  const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
  const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
  uint4 v;
  v.x = __byte_perm(lo01, lo23, 0x5410);
  v.y = __byte_perm(lo01, lo23, 0x7632);
  v.z = __byte_perm(hi01, hi23, 0x5410);
  v.w = __byte_perm(hi01, hi23, 0x7632);
  return v;
}

}  // namespace mma_s8
