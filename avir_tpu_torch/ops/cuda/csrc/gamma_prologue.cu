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
// Bit-equality with the in-kernel route holds by construction: every
// limb pair comes from k1::fill_q13_table (k1_common.cuh), whose entries
// are k1::gamma_in_q13 itself, the function K1's in-kernel stage calls,
// and the limb split is k1::limb_hi's integer decomposition.
//
// Design.  A thread owns one 16-lane group of a row: one 16-byte load of
// the image where the rows allow it (lanes % 16 == 0 and a 16-byte
// aligned base: the "vector" path, kVec; other images take the "byte"
// path, 16 bounded byte loads, in the same kernel), 16 table reads, and
// one 16-byte store into each plane (lanes_p is a multiple of 16).  A
// group starts on a multiple of 16 lanes, so lane k of a group is image
// lane % 4 == k % 4 and its table (colour or alpha) is fixed per k.  A
// block of 256 threads spans 64 groups x 4 rows and walks a band of 16
// rows (the four rows' loads issued before their stores), so the table
// fill (256 polynomial evaluations, 512 with an alpha lane, and two
// barriers) is amortized over 64
// elements a thread; the loads are issued before the table fill, so their
// latency overlaps it.  2-D grid (groups, row bands): 32-bit index math, no
// division or modulo per element.  Positions past the image read 0, whose
// limbs are 0 (gamma_in_q13 of 0 is 0 on both tables).
//
// Table against polynomial.  The table is the faster of the two: timed in
// alternating turns against k1::gamma_in_q13 evaluated in registers (the
// first port's arithmetic, ~15 float32 operations and a branch an element,
// bit-equal), on an H100 80GB HBM3 at 700 W it ran 0.106 ms against
// 0.109-0.113 at 7680 x 4320 RGB, where the bytes bound both, and
// 0.012-0.014 against 0.015-0.017 at 1920 x 1080, where the per-element
// arithmetic shows.  So only the table is built.
//
// What bounds it on this card: the image read once and the two planes
// written once (3 bytes per lane: 299 MB at 7680 x 4320 RGB, 89 us at
// 3.35 TB/s).  One shared-memory read an element (bank conflicts between
// the 32 random byte values of a warp) and the byte shuffles stay under
// that.

#include <cstdint>
#include <cuda_runtime.h>

#include "k1_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGx = 64;    // 16-lane groups a block spans
constexpr int kGy = kThreads / kGx;  // rows a block handles at once
constexpr int kBand = 16;  // rows a block walks
constexpr int kSteps = kBand / kGy;

struct Args {
  const uint8_t* x;
  int rows, lanes;     // x is [rows, lanes]
  uint4* hi;           // [rows_p, lanes_p / 16] 16-lane groups
  uint4* lo;
  int rows_p, groups;  // groups = lanes_p / 16
  k1::Epilogue epi;
};

// The four bytes of image word ``w`` (lanes k0..k0+3 of a group) as the
// hi and lo limb bytes of their q13, read from the packed limb tables.
__device__ __forceinline__ void limbs_of(const uint16_t* const (&tb)[4], uint32_t w,
                                         uint32_t& h, uint32_t& l) {
  const uint32_t p0 = tb[0][w & 0xffu], p1 = tb[1][(w >> 8) & 0xffu];
  const uint32_t p2 = tb[2][(w >> 16) & 0xffu], p3 = tb[3][w >> 24];
  // {h0, h1, l0, l1} and {h2, h3, l2, l3}, then the hi and lo bytes.
  const uint32_t a = __byte_perm(p0, p1, 0x5140), b = __byte_perm(p2, p3, 0x5140);
  h = __byte_perm(a, b, 0x5410);
  l = __byte_perm(a, b, 0x7632);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) gamma_prologue(const Args a) {
  // q13 of every byte value (colour, alpha), then each entry's two s8
  // limbs packed in a u16 (hi in the low byte).
  __shared__ int32_t q13[2][256];
  __shared__ uint16_t pairs[2][256];
  const int g = blockIdx.x * kGx + threadIdx.x % kGx;
  const int l0 = 16 * g;  // past lanes_p (and lanes) when g >= groups
  const int r0 = blockIdx.y * kBand + threadIdx.x / kGx;

  // The image first, so that its loads are in flight while the table fills.
  uint4 raw[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int r = r0 + kGy * i;
    raw[i] = make_uint4(0u, 0u, 0u, 0u);
    if (r >= a.rows || l0 >= a.lanes) continue;
    const uint8_t* p = a.x + static_cast<size_t>(r) * a.lanes + l0;
    if (kVec) {
      raw[i] = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      const int n = min(16, a.lanes - l0);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        if (e < n) w[e / 4] |= static_cast<uint32_t>(__ldg(p + e)) << (8 * (e % 4));
      }
      raw[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  // fill_q13_table fills the alpha half only where there is an alpha lane.
  k1::fill_q13_table(a.epi, q13);
  const int n = a.epi.alpha_lane >= 0 ? 512 : 256;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int32_t q = q13[i >> 8][i & 255], q1 = k1::limb_hi(q);
    pairs[i >> 8][i & 255] = static_cast<uint16_t>((q1 & 0xff) | ((q - 128 * q1) & 0xff) << 8);
  }
  __syncthreads();
  if (g >= a.groups) return;
  const uint16_t* const tb[4] = {
      pairs[k1::is_alpha(a.epi, 0)], pairs[k1::is_alpha(a.epi, 1)],
      pairs[k1::is_alpha(a.epi, 2)], pairs[k1::is_alpha(a.epi, 3)]};
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int r = r0 + kGy * i;
    if (r >= a.rows_p) break;
    const uint32_t in[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) limbs_of(tb, in[j], h[j], l[j]);
    const size_t o = static_cast<size_t>(r) * a.groups + g;
    a.hi[o] = make_uint4(h[0], h[1], h[2], h[3]);
    a.lo[o] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

}  // namespace

// vec: the rows are read by 16-byte loads (lanes % 16 == 0 and x 16-byte
// aligned, else cudaErrorInvalidValue).
extern "C" int avir_gamma_prologue(
    const void* x, int rows, int lanes,
    void* hi, void* lo, int rows_p, int lanes_p,
    int alpha_lane, float in_gamma_mult, int vec,
    void* stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (lanes_p % 16 != 0 || rows_p < rows || lanes_p < lanes || !aligned(hi) || !aligned(lo) ||
      (vec && (lanes % 16 != 0 || !aligned(x)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = static_cast<const uint8_t*>(x);
  a.rows = rows;
  a.lanes = lanes;
  a.hi = static_cast<uint4*>(hi);
  a.lo = static_cast<uint4*>(lo);
  a.rows_p = rows_p;
  a.groups = lanes_p / 16;
  a.epi = {};
  a.epi.alpha_lane = alpha_lane;
  a.epi.in_gamma_mult = in_gamma_mult;
  if (rows_p == 0 || a.groups == 0) return 0;
  const dim3 grid((a.groups + kGx - 1) / kGx, (rows_p + kBand - 1) / kBand);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    gamma_prologue<true><<<grid, kThreads, 0, s>>>(a);
  } else {
    gamma_prologue<false><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
