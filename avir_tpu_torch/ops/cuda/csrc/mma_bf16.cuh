// Building blocks of the bf16 tensor-core kernels (fused_split.cu,
// banded.cu, lanes.cu, planar.cu): ldmatrix, mma.sync m16n8k16 bf16 x bf16
// -> f32, and the error-free bf16 split of float32 pairs.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

#include "cp_async.cuh"

namespace mma_bf16 {

using cp_async::smem_addr;

// Four 8x8 bf16 matrices; thread l names row (l & 15) at column (l >> 4) * 8
// of a 16x16 tile: an A fragment of m16n8k16, or with .trans on a [K][N]
// tile the B fragments of two n8 tiles ({r0, r1} for columns 0-7, {r2, r3}
// for 8-15).
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a * b, m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Error-free split of (x, y) into packed bf16 pairs hi = bf16(.), lo =
// bf16(. - hi), x in the low half.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(x, hf.x), __fsub_rn(y, hf.y)));
}

}  // namespace mma_bf16
