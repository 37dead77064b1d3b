// Linearize-once sRGB prologue (K5) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// avir_tpu/ops/pallas/gamma_prologue.py: apply_gamma_prologue -> _kernel.
// It reads a u8 sRGB image [rows, lanes], multiplies by in_gamma_mult,
// linearizes to 13-bit fixed point (the degree-7 u8-grid polynomial of
// K1's int8 gamma stage; the C = 4 alpha lane only scaled) and splits the
// result into its two balanced radix-128 s8 limbs, written as two planes
// [rows_p, lanes_p] (zero past the image): the limb-plane input that K1
// int8 reads in place of the u8 image and its in-kernel polynomial
// (fused_int8.cu, GAMMA_PRE).
//
// Bit-equality with the in-kernel route holds by construction: the
// linearization is k1::gamma_in_q13 from k1_common.cuh, the very function
// K1's in-kernel stage calls, and the limb split is the same integer
// decomposition.
//
// Design: one thread per 4 consecutive lanes of one row (lanes_p is a
// multiple of 4), each limb plane stored as one 32-bit word.  What bounds
// it on this card: the image read once and the two planes written once
// (3 bytes per pixel lane: 299 MB at 7680 x 4320 RGB, 89 us at 3.35
// TB/s); the polynomial's ~15 float32 operations per element stay below
// that at the CUDA cores' 67 TFLOP/s.

#include <cstdint>
#include <cuda_runtime.h>

#include "k1_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) gamma_prologue(
    const uint8_t* __restrict__ x, int rows, int lanes,
    uint32_t* __restrict__ hi, uint32_t* __restrict__ lo, int rows_p, int lanes_p,
    k1::Epilogue epi) {
  const int words = lanes_p / 4;
  const size_t n = static_cast<size_t>(rows_p) * words;
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    const int r = static_cast<int>(i / words);
    const int l0 = static_cast<int>(i % words) * 4;
    uint32_t w1 = 0, w0 = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = l0 + k;
      int32_t q = 0;
      if (r < rows && l < lanes) {
        q = k1::gamma_in_q13(epi, __ldg(x + static_cast<size_t>(r) * lanes + l), l);
      }
      const int32_t q1 = k1::limb_hi(q);
      w1 |= (static_cast<uint32_t>(q1) & 0xffu) << (8 * k);
      w0 |= (static_cast<uint32_t>(q - q1 * 128) & 0xffu) << (8 * k);
    }
    hi[i] = w1;
    lo[i] = w0;
  }
}

}  // namespace

extern "C" int avir_gamma_prologue(
    const void* x, int rows, int lanes,
    void* hi, void* lo, int rows_p, int lanes_p,
    int alpha_lane, float in_gamma_mult,
    void* stream) {
  if (lanes_p % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  k1::Epilogue epi = {};
  epi.alpha_lane = alpha_lane;
  epi.in_gamma_mult = in_gamma_mult;
  const size_t n = static_cast<size_t>(rows_p) * (lanes_p / 4);
  if (n == 0) return 0;
  const size_t blocks = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 65536 ? blocks : 65536);
  gamma_prologue<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), rows, lanes,
      static_cast<uint32_t*>(hi), static_cast<uint32_t*>(lo), rows_p, lanes_p, epi);
  return static_cast<int>(cudaGetLastError());
}
