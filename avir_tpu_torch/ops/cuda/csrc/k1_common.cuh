// K1's sRGB stages and output epilogue, shared by fused_int8.cu and
// fused_split.cu.
//
// Replaces, in the JAX package's avir_tpu/ops/pallas/fused_kernel.py:
// _srgb_to_linear (:69, split-mode pack stage), _srgb_to_linear13_u8poly
// (:117, int8-mode pack stage), _linear_to_srgb (:79, unpack stage) and
// _finish (:400, scale, round-half-even or biased rounding, truncation,
// clamp), with the C=4 alpha-lane bypass (_alpha_mask :40).
//
// Rounding.  The JAX package's kernel, as XLA compiles it on the CPU
// (interpret mode, the port's reference), contracts each a * b + c of
// these forms into one fused multiply-add.  Here those FMAs are written
// out as __fmaf_rn and every other step is one _rn intrinsic, in the
// reference's operation order, so no compiler contraction can move a
// rounding: the kernels, their plain PyTorch versions (ops/gamma.py,
// ops/cuda/fused_kernel.py:finish_reference) and interpret-mode Pallas
// agree bit for bit on these stages.  Constants are the float32
// roundings of the reference's double values ((float) of a double
// expression, as NumPy's float32() of a Python float).  Built without
// --use_fast_math: the square roots, the division and the rounding stay
// IEEE.

#pragma once

#include <cstdint>

namespace k1 {

// Output stage of one launch (all fields per launch, read-only).
struct Epilogue {
  int alpha_lane;        // lane % 4 of the alpha channel (C = 4), or -1
  float in_gamma_mult;   // input scale to [0, 1] before linearization
  float out_gamma_mult;  // output scale after gamma-out; 0 = none
  float scale;           // LANCIR's output scale; 1 = none
  int even;              // round half to even; else floor(v + 0.5)
  int trunc_bits;        // > 0: quantize in steps of tm (biased)
  float tm;
  float out_max;
};

__device__ __forceinline__ bool is_alpha(const Epilogue& e, int lane) {
  return e.alpha_lane >= 0 && (lane & 3) == e.alpha_lane;
}

// Degree-9 linearization of the split modes (_F32_LIN_COEF), x in [0, 1].
__device__ __forceinline__ float srgb_to_linear(float x) {
  if (x <= static_cast<float>(0.04045)) {
    return __fmul_rn(x, static_cast<float>(1.0 / 12.92));
  }
  float acc = static_cast<float>(0.05739567406964825);
  acc = __fmaf_rn(acc, x, static_cast<float>(-0.32497847508180217));
  acc = __fmaf_rn(acc, x, static_cast<float>(0.820447767639579));
  acc = __fmaf_rn(acc, x, static_cast<float>(-1.2337517794771542));
  acc = __fmaf_rn(acc, x, static_cast<float>(1.257590813503784));
  acc = __fmaf_rn(acc, x, static_cast<float>(-0.9850409244814118));
  acc = __fmaf_rn(acc, x, static_cast<float>(0.8900508390762532));
  acc = __fmaf_rn(acc, x, static_cast<float>(0.48196428400734187));
  acc = __fmaf_rn(acc, x, static_cast<float>(0.035465890603903136));
  return __fmaf_rn(acc, x, static_cast<float>(0.0008536138646303981));
}

// round(linear(x) * 2^13), round half to even, for x on the u8 grid in
// [0, 1] (_U8_LIN_COEF, the 2^13 scale folded into the coefficients).
__device__ __forceinline__ int32_t srgb_to_linear13(float x) {
  constexpr double k = 8192.0;
  float lin;
  if (x <= static_cast<float>(0.04045)) {
    lin = __fmul_rn(x, static_cast<float>(k / 12.92));
  } else {
    float acc = static_cast<float>(0.05454610085971551 * k);
    acc = __fmaf_rn(acc, x, static_cast<float>(-0.2526727088789862 * k));
    acc = __fmaf_rn(acc, x, static_cast<float>(0.5113014176950982 * k));
    acc = __fmaf_rn(acc, x, static_cast<float>(-0.6398338110899012 * k));
    acc = __fmaf_rn(acc, x, static_cast<float>(0.7946677002602778 * k));
    acc = __fmaf_rn(acc, x, static_cast<float>(0.4967742755734233 * k));
    acc = __fmaf_rn(acc, x, static_cast<float>(0.034331778643864906 * k));
    lin = __fmaf_rn(acc, x, static_cast<float>(0.0008849456939997724 * k));
  }
  return __float2int_rn(lin);
}

// The int8 mode's first-pass input: u8 sRGB -> 13-bit linear light; the
// alpha lane is only scaled.
__device__ __forceinline__ int32_t gamma_in_q13(const Epilogue& e, uint8_t x, int lane) {
  const float v = __fmul_rn(static_cast<float>(x), e.in_gamma_mult);
  if (is_alpha(e, lane)) return __float2int_rn(__fmul_rn(v, 8192.0f));
  return srgb_to_linear13(v);
}

// gamma_in_q13 of every u8 value, in a block's shared table: q13[0] for a
// colour lane, q13[1] (filled only with an alpha lane) for the alpha lane.
// One thread per entry, then one __syncthreads.  The entries come from
// gamma_in_q13 itself, so a table read gives its bits.
__device__ __forceinline__ void fill_q13_table(const Epilogue& e, int32_t (*q13)[256]) {
  const int n = e.alpha_lane >= 0 ? 512 : 256;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int alpha = i >> 8;
    // A lane of the entry's kind: the alpha lane itself, or the next one.
    const int lane = alpha ? e.alpha_lane : ((e.alpha_lane + 1) & 3);
    q13[alpha][i & 255] = gamma_in_q13(e, static_cast<uint8_t>(i & 255), lane);
  }
  __syncthreads();
}

// gamma_in_q13(e, x, lane) read from the table.
__device__ __forceinline__ int32_t q13_of(const Epilogue& e, const int32_t (*q13)[256],
                                          uint8_t x, int lane) {
  return q13[is_alpha(e, lane) ? 1 : 0][x];
}

// The int8 mode's integer steps, shared by every kernel of that route
// (fused_int8.cu, gamma_prologue.cu, fused_ring.cu) so that their limbs
// and sums agree by construction.
// High limb of the balanced radix-128 split q = 128 * hi + lo, |lo| <= 64.
__device__ __forceinline__ int32_t limb_hi(int32_t q) { return (q + 64) >> 7; }

// The first pass's exact sum requantized to the 15-bit intermediate.
__device__ __forceinline__ int32_t requant(int32_t fq, int sh) {
  return (fq + (1 << (sh - 1))) >> sh;
}

// The second pass's limb sums recombined in float32, times rec = 2^-k.
__device__ __forceinline__ float recombine(int32_t pa, int32_t pb, float rec) {
  const float acc = __fadd_rn(__fmul_rn(__int2float_rn(pa), 16384.0f),
                              __fmul_rn(__int2float_rn(pb), 128.0f));
  return __fmul_rn(acc, rec);
}

// The split modes' pack stage.
__device__ __forceinline__ float gamma_in(const Epilogue& e, float x, int lane) {
  const float v = __fmul_rn(x, e.in_gamma_mult);
  return is_alpha(e, lane) ? v : srgb_to_linear(v);
}

// _linear_to_srgb: 1.055 * x^(1/2.4) - 0.055 by the reference's
// _pow24i_srgb form, 12.92 * x below 0.0031308.
__device__ __forceinline__ float linear_to_srgb(float x) {
  if (x <= static_cast<float>(0.0031308)) {
    return __fmul_rn(x, static_cast<float>(12.92));
  }
  const float sx = __fsqrt_rn(x);
  const float ssx = __fsqrt_rn(sx);
  const float sssx = __fsqrt_rn(ssx);
  float t = __fmaf_rn(static_cast<float>(0.0149409239419218), x,
                      static_cast<float>(0.000213364515060263));
  t = __fmaf_rn(static_cast<float>(0.433973412731747), sx, t);
  float u = __fmaf_rn(static_cast<float>(0.659628181609715), sssx,
                      -static_cast<float>(0.0380957908841466));
  u = __fmaf_rn(-static_cast<float>(0.0706476137208521), sx, u);
  const float r = __fmaf_rn(ssx, u, t);
  return __fmaf_rn(static_cast<float>(1.055), r, -static_cast<float>(0.055));
}

// Float32 output: gamma-out and its multiplier; no scale, no rounding.
template <bool GAMMA>
__device__ __forceinline__ float finish_float(const Epilogue& e, float acc, int lane) {
  if (GAMMA) {
    if (!is_alpha(e, lane)) acc = linear_to_srgb(acc);
    if (e.out_gamma_mult != 0.0f) acc = __fmul_rn(acc, e.out_gamma_mult);
  }
  return acc;
}

// Integer output: gamma-out, scale, rounding, clamp.  The last multiply
// before a biased rounding fuses with its + 0.5, as in the reference.
template <bool GAMMA>
__device__ __forceinline__ float finish_int(const Epilogue& e, float acc, int lane) {
  float mul = 1.0f;
  bool has_mul = false;
  if (GAMMA) {
    if (!is_alpha(e, lane)) acc = linear_to_srgb(acc);
    if (e.out_gamma_mult != 0.0f) {
      mul = e.out_gamma_mult;
      has_mul = true;
    }
  }
  if (e.scale != 1.0f) {
    if (has_mul) acc = __fmul_rn(acc, mul);
    mul = e.scale;
    has_mul = true;
  }
  float v;
  if (e.trunc_bits > 0) {
    if (has_mul) acc = __fmul_rn(acc, mul);
    v = __fmul_rn(floorf(__fadd_rn(__fdiv_rn(acc, e.tm), 0.5f)), e.tm);
  } else if (e.even) {
    if (has_mul) acc = __fmul_rn(acc, mul);
    v = rintf(acc);
  } else {
    v = floorf(has_mul ? __fmaf_rn(acc, mul, 0.5f) : __fadd_rn(acc, 0.5f));
  }
  return fminf(fmaxf(v, 0.0f), e.out_max);
}

}  // namespace k1
