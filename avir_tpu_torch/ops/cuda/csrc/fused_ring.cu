// Shift-ring int8 sRGB-gamma resize (K6) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// avir_tpu/ops/pallas/fused_ring_kernel.py: apply_fused_ring_pallas ->
// _kernel.  It computes the function of K1's int8 gamma route in order
// "vh" (fused_int8.cu with GAMMA): u8 sRGB [rows_in, lanes_in] -> u8
// [rows_out, lanes_out], bit for bit, by the same integer steps
// (k1_common.cuh: gamma_in_q13, limb_hi, requant, recombine, finish_int).
//
// What it saves.  K1 linearizes each input element every time a thread
// block stages it: 2.98 times per input byte at 7680x4320 -> 1920x1080
// (each 32-row slice's tap rows overlap the next slice's, and each
// 128-lane chunk's window overlaps the next chunk's).  On the TPU the ring
// kernel keeps the linearized window of a column in VMEM across the
// sequential grid; a Hopper block has no sequential grid and 227 KB of
// shared memory, less than one chunk's window of limb rows (1024 lanes x
// 384 rows x 2 bytes).  So the design turns the ring sideways:
//
//   - A thread block owns one 128-lane INPUT segment and a run of
//     consecutive 32-row output slices (a part of the column).  It keeps
//     the segment's linearized limb rows in a ring in shared memory
//     (ring_rows rows: the largest tap-row range of one slice, 192 at
//     8K), indexed by absolute row mod ring_rows.  For the run's first
//     slice it linearizes the slice's whole tap-row range (the preload);
//     for each next slice only the rows past the previous slice's end.
//     Rows above the image (pad_top of the uniform operator) and below it
//     read as 0, whose linearization is 0: no padded copy of the image.
//   - Per slice, the first (vertical) pass over the ring gives the exact
//     s32 sums for 32 rows x 128 lanes; they are requantized to the 15-bit
//     intermediate and split into s8 limbs (shared memory).
//   - The second (horizontal) pass needs all window lanes of an output
//     chunk, which span several segments.  Its limb sums are exact s32
//     integers, so each block adds its segment's share of them, for every
//     (chunk, window offset) pair whose nonzero H taps cover the segment,
//     to acc[2][rows_out][lanes_out] with atomicAdd (integer addition is
//     exact in any order, so the result is the same as K1's).  A second
//     kernel recombines the two sums and runs the epilogue.
//   So each input element is linearized once per part of its column
//   (chip_smoke.py prints the factor, padding excluded), and the first
//   pass, which K1 repeats with the linearization, runs once too.
//
// Shared memory: the ring (ring_rows x 128 lanes x 2 limbs; 48 KB at 192
// rows), the V taps of 32 rows x 32 contraction rows, the intermediate's
// limbs (8 KB) and one pair's H taps (32 KB): dynamic, about 90 KB.
// 256 threads, each owning 4 rows x 4 lanes as in K1.
//
// What bounds it on this card.  The image read once and the output
// written once: ~0.032 ms at 8K (3.35 TB/s), as for K1 int8 vh.  This
// first version runs its products with dp4a on the CUDA cores over dense
// 32-row tap blocks, and adds its H-pass shares with global atomics, so
// it is bound by dp4a issue and the atomics, far above that bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "k1_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;    // output rows per slice
constexpr int kLanes = 128;  // lanes per input segment and per output chunk
constexpr int kDepth4 = 8;   // 32 contraction rows, 4 per word

struct Args {
  const uint8_t* x;        // u8 image [rows_in, lanes_in]
  int rows_in, lanes_in;
  int pad_top;             // padded row r is image row r - pad_top
  uint8_t* out;            // [rows_out, lanes_out]
  int32_t* acc;            // [2][rows_out][lanes_out], zeroed: pa, pb
  int rows_out, lanes_out, tc;
  const int8_t* v1;        // [Bv, Tv, Wv]
  const int8_t* v0;
  const int32_t* offs_v;   // [Bv] window starts, padded rows
  int tv, wv;
  const uint32_t* h1p;     // [Bh * n_ch, win_c/4, 128] packed along win_c
  const uint32_t* h0p;
  int n_ch, win_c;
  const int32_t* k_range;  // [Bv, n_slices, 2] nonzero V-tap rows, 32-aligned
  int n_slices;
  const int32_t* segs;     // [n_seg] input segment of each block column
  const int32_t* seg_ptr;  // [n_seg + 1]
  const int32_t* pair_chunk;
  const int32_t* pair_off;
  const int32_t* slices;   // active slices vb * n_slices + sl, in order
  const int32_t* part_ptr; // [parts + 1] runs of slices
  int ring_rows;
  int sh;
  float rec;
  k1::Epilogue epi;
};

// Linearize padded rows [r0, r1) (multiples of 4) of the block's segment
// into the ring: thread t owns lane t % 128 and every second row quad.
__device__ __forceinline__ void fill_ring(const Args& a, int lane, int r0, int r1,
                                          uint32_t (*ring1)[kLanes],
                                          uint32_t (*ring0)[kLanes]) {
  const int l = threadIdx.x % kLanes;
  const int gl = lane + l;
  for (int r = r0 + 4 * (threadIdx.x / kLanes); r < r1; r += 4 * (kThreads / kLanes)) {
    uint32_t w1 = 0, w0 = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ir = r + k - a.pad_top;
      int32_t q = 0;
      if (ir >= 0 && ir < a.rows_in && gl < a.lanes_in) {
        q = k1::gamma_in_q13(a.epi, __ldg(a.x + static_cast<size_t>(ir) * a.lanes_in + gl), gl);
      }
      const int32_t q1 = k1::limb_hi(q);
      w1 |= (static_cast<uint32_t>(q1) & 0xffu) << (8 * k);
      w0 |= (static_cast<uint32_t>(q - q1 * 128) & 0xffu) << (8 * k);
    }
    const int slot = (r % a.ring_rows) / 4;
    ring1[slot][l] = w1;
    ring0[slot][l] = w0;
  }
}

__device__ __forceinline__ uint32_t byte_of(int32_t v, int i) {
  return (static_cast<uint32_t>(v) & 0xffu) << (8 * i);
}

__global__ void __launch_bounds__(kThreads) fused_ring_vh(const Args a) {
  const int seg = a.segs[blockIdx.x];
  const int lane = seg * kLanes;  // first padded lane of the segment
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;

  extern __shared__ __align__(16) uint32_t smem[];
  const int ring_words = a.ring_rows / 4;
  uint32_t (*ring1)[kLanes] = reinterpret_cast<uint32_t (*)[kLanes]>(smem);
  uint32_t (*ring0)[kLanes] = ring1 + ring_words;
  uint32_t (*sh1)[kLanes] = ring0 + ring_words;   // H taps [32 words][128]
  uint32_t (*sh0)[kLanes] = sh1 + kLanes / 4;
  uint32_t (*sl1)[kLanes / 4] = reinterpret_cast<uint32_t (*)[kLanes / 4]>(sh0 + kLanes / 4);
  uint32_t (*sl0)[kLanes / 4] = sl1 + kRows;      // x1/x0 limbs, packed along lanes
  uint32_t (*sv1)[kDepth4] = reinterpret_cast<uint32_t (*)[kDepth4]>(sl0 + kRows);
  uint32_t (*sv0)[kDepth4] = sv1 + kRows;         // V tap limbs [32 rows][8 words]

  const int p0 = a.part_ptr[blockIdx.y], p1 = a.part_ptr[blockIdx.y + 1];
  const int q0 = a.seg_ptr[blockIdx.x], q1 = a.seg_ptr[blockIdx.x + 1];
  int done = 0;  // padded rows below this are in the ring
  for (int p = p0; p < p1; ++p) {
    const int g = a.slices[p];
    const int vb = g / a.n_slices, r0 = (g % a.n_slices) * kRows;
    const int row0 = a.offs_v[vb];
    const int k_lo = a.k_range[2 * g], k_hi = a.k_range[2 * g + 1];
    // ---- linearize the slice's new rows into the ring ---------------
    const int lo = row0 + k_lo, hi = row0 + k_hi;
    fill_ring(a, lane, p == p0 ? lo : max(done, lo), hi, ring1, ring0);
    done = hi;
    // ---- first (vertical) pass: m1 = q1v.xq1, m0 = q1v.xq0, m2 = q0v.xq1
    int32_t m1[4][4] = {}, m0[4][4] = {}, m2[4][4] = {};
    for (int k0 = k_lo; k0 < k_hi; k0 += 4 * kDepth4) {
      __syncthreads();
      {
        const int r = tid / kDepth4, w = tid % kDepth4;
        const int tr = r0 + r;
        uint32_t t1 = 0, t0 = 0;
        if (tr < a.tv) {
          const size_t off = (static_cast<size_t>(vb) * a.tv + tr) * a.wv + k0 + 4 * w;
          t1 = __ldg(reinterpret_cast<const uint32_t*>(a.v1 + off));
          t0 = __ldg(reinterpret_cast<const uint32_t*>(a.v0 + off));
        }
        sv1[r][w] = t1;
        sv0[r][w] = t0;
      }
      __syncthreads();
      const int slot = ((row0 + k0) % a.ring_rows) / 4;
#pragma unroll
      for (int k4 = 0; k4 < kDepth4; ++k4) {
        const uint4 xb = *reinterpret_cast<const uint4*>(&ring1[slot + k4][4 * tx]);
        const uint4 xc = *reinterpret_cast<const uint4*>(&ring0[slot + k4][4 * tx]);
        const int xv[4] = {static_cast<int>(xb.x), static_cast<int>(xb.y),
                           static_cast<int>(xb.z), static_cast<int>(xb.w)};
        const int xl[4] = {static_cast<int>(xc.x), static_cast<int>(xc.y),
                           static_cast<int>(xc.z), static_cast<int>(xc.w)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t1 = static_cast<int>(sv1[4 * ty + i][k4]);
          const int t0 = static_cast<int>(sv0[4 * ty + i][k4]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            m1[i][jj] = __dp4a(t1, xv[jj], m1[i][jj]);
            m0[i][jj] = __dp4a(t1, xl[jj], m0[i][jj]);
            m2[i][jj] = __dp4a(t0, xv[jj], m2[i][jj]);
          }
        }
      }
    }
    // ---- requantize to two s8 limbs, packed along lanes -------------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t w1 = 0, w0 = 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int32_t fq = m1[i][jj] * 16384 + (m0[i][jj] + m2[i][jj]) * 128;
        const int32_t x15 = k1::requant(fq, a.sh);
        const int32_t x1 = k1::limb_hi(x15);
        w1 |= byte_of(x1, jj);
        w0 |= byte_of(x15 - x1 * 128, jj);
      }
      sl1[4 * ty + i][tx] = w1;
      sl0[4 * ty + i][tx] = w0;
    }
    // ---- second (horizontal) pass: this segment's share, per pair ----
    for (int q = q0; q < q1; ++q) {
      const int chunk = a.pair_chunk[q];
      __syncthreads();
      {
        const size_t base =
            (static_cast<size_t>(chunk) * (a.win_c / 4) + a.pair_off[q] / 4) * kLanes / 4;
        const uint4* g1 = reinterpret_cast<const uint4*>(a.h1p) + base;
        const uint4* g0 = reinterpret_cast<const uint4*>(a.h0p) + base;
        for (int e = tid; e < (kLanes / 4) * kLanes / 4; e += kThreads) {
          reinterpret_cast<uint4*>(&sh1[0][0])[e] = __ldg(g1 + e);
          reinterpret_cast<uint4*>(&sh0[0][0])[e] = __ldg(g0 + e);
        }
      }
      __syncthreads();
      int32_t pa[4][4] = {}, pb[4][4] = {};
#pragma unroll 4
      for (int k4 = 0; k4 < kLanes / 4; ++k4) {
        const uint4 t1 = *reinterpret_cast<const uint4*>(&sh1[k4][4 * tx]);
        const uint4 t0 = *reinterpret_cast<const uint4*>(&sh0[k4][4 * tx]);
        const int h1[4] = {static_cast<int>(t1.x), static_cast<int>(t1.y),
                           static_cast<int>(t1.z), static_cast<int>(t1.w)};
        const int h0[4] = {static_cast<int>(t0.x), static_cast<int>(t0.y),
                           static_cast<int>(t0.z), static_cast<int>(t0.w)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int x1 = static_cast<int>(sl1[4 * ty + i][k4]);
          const int x0 = static_cast<int>(sl0[4 * ty + i][k4]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            pa[i][jj] = __dp4a(x1, h1[jj], pa[i][jj]);
            pb[i][jj] = __dp4a(x0, h1[jj], pb[i][jj]);
            pb[i][jj] = __dp4a(x1, h0[jj], pb[i][jj]);
          }
        }
      }
      const int hb = chunk / a.n_ch, j = chunk % a.n_ch;
      const size_t plane = static_cast<size_t>(a.rows_out) * a.lanes_out;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tr = r0 + 4 * ty + i;
        const int orow = vb * a.tv + tr;
        if (tr >= a.tv || orow >= a.rows_out) continue;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int cl = j * kLanes + 4 * tx + jj;
          const int olane = hb * a.tc + cl;
          if (cl >= a.tc || olane >= a.lanes_out) continue;
          int32_t* dst = a.acc + static_cast<size_t>(orow) * a.lanes_out + olane;
          if (pa[i][jj] != 0) atomicAdd(dst, pa[i][jj]);
          if (pb[i][jj] != 0) atomicAdd(dst + plane, pb[i][jj]);
        }
      }
    }
    __syncthreads();  // the next slice's ring rows overwrite rows read here
  }
}

// Recombine the two sums of every output element and run K1's epilogue.
__global__ void __launch_bounds__(kThreads) fused_ring_finish(const Args a) {
  const size_t n = static_cast<size_t>(a.rows_out) * a.lanes_out;
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * kThreads) {
    const float acc = k1::recombine(a.acc[i], a.acc[n + i], a.rec);
    const int lane = static_cast<int>(i % a.lanes_out);
    a.out[i] = static_cast<uint8_t>(static_cast<int>(k1::finish_int<true>(a.epi, acc, lane)));
  }
}

}  // namespace

extern "C" int avir_fused_ring(
    const void* x, int rows_in, int lanes_in, int pad_top,
    void* out, void* acc, int rows_out, int lanes_out, int tc,
    const void* v1, const void* v0, const void* offs_v,
    int tv, int wv,
    const void* h1p, const void* h0p,
    int n_ch, int win_c,
    const void* k_range, int n_slices,
    const void* segs, int n_seg, const void* seg_ptr,
    const void* pair_chunk, const void* pair_off,
    const void* slices, const void* part_ptr, int parts,
    int ring_rows,
    int sh, float rec,
    int alpha_lane, float in_gamma_mult, float out_gamma_mult,
    void* stream) {
  if (ring_rows % 32 != 0 || ring_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const uint8_t*>(x);
  a.rows_in = rows_in;
  a.lanes_in = lanes_in;
  a.pad_top = pad_top;
  a.out = static_cast<uint8_t*>(out);
  a.acc = static_cast<int32_t*>(acc);
  a.rows_out = rows_out;
  a.lanes_out = lanes_out;
  a.tc = tc;
  a.v1 = static_cast<const int8_t*>(v1);
  a.v0 = static_cast<const int8_t*>(v0);
  a.offs_v = static_cast<const int32_t*>(offs_v);
  a.tv = tv;
  a.wv = wv;
  a.h1p = static_cast<const uint32_t*>(h1p);
  a.h0p = static_cast<const uint32_t*>(h0p);
  a.n_ch = n_ch;
  a.win_c = win_c;
  a.k_range = static_cast<const int32_t*>(k_range);
  a.n_slices = n_slices;
  a.segs = static_cast<const int32_t*>(segs);
  a.seg_ptr = static_cast<const int32_t*>(seg_ptr);
  a.pair_chunk = static_cast<const int32_t*>(pair_chunk);
  a.pair_off = static_cast<const int32_t*>(pair_off);
  a.slices = static_cast<const int32_t*>(slices);
  a.part_ptr = static_cast<const int32_t*>(part_ptr);
  a.ring_rows = ring_rows;
  a.sh = sh;
  a.rec = rec;
  a.epi.alpha_lane = alpha_lane;
  a.epi.in_gamma_mult = in_gamma_mult;
  a.epi.out_gamma_mult = out_gamma_mult;
  a.epi.scale = 1.0f;
  a.epi.even = 0;
  a.epi.trunc_bits = 0;
  a.epi.tm = 1.0f;
  a.epi.out_max = 255.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes =
      (2 * (ring_rows / 4) * kLanes + 2 * (kLanes / 4) * kLanes + 2 * kRows * (kLanes / 4) +
       2 * kRows * kDepth4) * sizeof(uint32_t);
  cudaError_t e = cudaFuncSetAttribute(
      fused_ring_vh, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_seg > 0 && parts > 0) {
    fused_ring_vh<<<dim3(n_seg, parts), kThreads, bytes, s>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t n = static_cast<size_t>(rows_out) * lanes_out;
  const size_t blocks = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 65536 ? blocks : 65536);
  if (grid > 0) fused_ring_finish<<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
