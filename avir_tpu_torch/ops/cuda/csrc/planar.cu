// Planar fused split-bf16 resizes (K7 and K8) for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas kernels of the JAX package, both the split-bf16
// fused V -> H resize with a DENSE per-channel H operator (the lane form
// of the H pass at C = 1, [Wh, Th] per block, instead of K1's
// channel-diagonal [Wh*C, Th*C]):
//   K7  avir_tpu/ops/pallas/planar_kernel.py: apply_planar_pallas ->
//       _kernel.  Input planar-stacked [c*hp, wp] (plane p's row r at
//       p*hp + r); output planar [c*Bv*Tv, Bh*Th].  Gamma with a whole
//       alpha plane bypassing the curves (scaled only).
//   K8  avir_tpu/ops/pallas/planar2_kernel.py: apply_planar2_pallas ->
//       _kernel.  Input interleaved [rows, W*C]; output channel-grouped
//       [Bv*Tv, Bh*C*Th].  Gamma-in on the interleaved window with the
//       C = 4 alpha lane mask; gamma-out per channel, skipping alpha_ch.
// One kernel serves both: a thread block works on one channel, and the
// layout only changes how it stages that channel's pixels (K7's plane
// rows, or K8's every C-th element of a row from element p).  On the TPU,
// K8 de-interleaves the V result in VMEM with strided lane slices, which
// Mosaic cannot lower; here it de-interleaves as it stages the first
// pass's image tile (below).  The alpha bypass is a per-block choice,
// handed to k1_common.cuh's stages as a lane that is (0) or is not (1)
// the alpha lane: with C = 4 the interleaved lane mask of K8's gamma-in
// picks one channel, so it is one too.
//
// Arithmetic (the same function as the TPU kernels, summed in another
// order, so equal to float32 rounding and not bit for bit), as in
// fused_split.cu: input u8/u16 -> f32 exactly (or f32); gamma: x =
// poly9(x * in_gamma_mult) (the alpha plane / channel: x * in_gamma_mult);
// a pass in split2 sums t_hi*x_hi + t_lo*x_hi, split3 adds t_hi*x_lo,
// with hi = bf16(x), lo = bf16(x - hi) (__float2bfloat16_rn and __fsub_rn,
// so nvcc cannot contract the residual); every product is bf16 x bf16,
// exact in f32; the intermediate is split the same way; the epilogue is
// k1_common.cuh's (gamma-out, out_gamma_mult, scale, rounding, clamp).
//
// Design: K1 split vh's tensor-core kernel (fused_split.cu) for one
// channel, with the dense H operator.  Both passes run on mma.sync
// m16n8k16 (row.col, bf16 operands, f32 accumulators) from ldmatrix
// fragments (.trans for the [K, N] operands); the helpers come from
// mma_bf16.cuh, cp_async.cuh and pack4.cuh.  A block owns kRows = 64
// output rows (a slice of one V block), one 128-pixel output chunk of one
// H block and one channel, with 8 warps of 16 rows x 64 pixels.  The channel varies fastest among the blocks, so K8's C
// blocks that read the same rows run together and share L2.  For each
// segment of up to 128 window pixels of the chunk's nonzero H-tap range
// (h_range, 32-aligned):
//   - the first pass over the slice's nonzero V-tap rows (k_range at
//     64-row slices), 32 a step: the V taps (bf16, as stored) come by
//     cp.async, the image rows by loads into registers (one vector load
//     of 4 pixels where the plane is contiguous and its rows and base
//     16-byte aligned, else 4 loads at the plane's stride, zeros past its
//     edge: K7's rows at or past hp, K8's pixels past the row) or, for K8
//     with a raw span tile, by cp.async (below); converted to f32,
//     linearized with gamma and split into bf16 hi/lo once per staged
//     element;
//   - the segment's last first-pass step splits the accumulators into a
//     bf16 hi/lo intermediate tile in shared memory;
//   - the second pass: the segment's dense H taps (bf16, 32 window pixels
//     a step, cp.async) times the intermediate, into the block's output
//     accumulators; 16-pixel groups past the chunk's last output pixel
//     are skipped.
// All steps of both passes and all segments form one sequence with double
// buffers: while a step's MMAs run, the next step's taps are in flight by
// cp.async and its image rows in registers; one barrier ends a step.
// Shared-memory rows are padded (V taps to 40 bf16, 128-pixel tiles to
// 136) so that the 8 rows of each ldmatrix phase fall in distinct banks;
// every tap row starts 16-byte aligned (Wv and the chunked H-tap rows are
// multiples of 128 taps, k_range and h_range multiples of 32).  90,112 B
// of shared memory, two blocks an SM.  A 32-row slice (62,464 B) stages
// each element more often (2.44 against 1.82 times at 8K) for fewer MACs,
// and ran 3-10% slower at both planar shapes of chip_smoke.py (H100 80GB
// HBM3, 700 W: K7 0.503-0.514 ms against 0.481-0.489 at 7680x4320 ->
// 1920x1080 u8 RGB, 0.557-0.559 against 0.504-0.508 at 1920x1080 ->
// 3840x2160 u16 RGBA gamma; K8 0.569-0.583 against 0.523-0.534 and
// 0.614-0.622 against 0.556-0.563), so 64 is the only height.
//
// K8's de-interleave.  Where 32 rows of a step's raw interleaved span (128
// pixels of all C channels, from the 16-byte boundary before them) fit a
// 25,600-byte tile beside the rest (u8 up to C = 6, u16 up to 3, f32 at 1)
// and the rows are 16-byte aligned (raw_ld > 0; planar.py:raw_row_bytes),
// the block copies that span by 16-byte cp.async pieces (zeros past the
// row and the image) and, after a barrier, reads its channel from shared
// memory at a stride of C as it converts and splits: one more barrier a
// first-pass step, but contiguous 16-byte copies instead of one element a
// load.  Otherwise each block loads its channel's pixels at a stride of C
// into registers.  Either way the C blocks of a chunk each bring the
// whole span from L2 (C times the bytes into the SMs).  At 7680x4320 ->
// 1920x1080 u8 RGB the raw tile ran 0.523-0.534 ms against 0.721-0.727 by
// strided loads (K7: 0.481-0.489; chip_smoke.py, H100 80GB HBM3, 700 W).
// One block for all C channels would stage the span once, but needs C
// output accumulator tiles (C x 32 registers a thread) beside
// the intermediate's, beyond the 128 registers of two blocks an SM.
//
// What bounds it on this card.  The image read once, the output written
// once and the taps once (bytes, 3.35 TB/s): 0.032 ms at 7680x4320 ->
// 1920x1080 u8 RGB.  The MMAs multiply dense tap blocks, 7-8x the band's
// MACs (35.0 G there, chip_smoke.py prints both counts): 0.071 ms at the
// bf16 tensor-core rate.  What sets the pace is the staging: each image
// element is staged once per block whose window covers it (1.8 times at
// 8K, 5.8 at 1920x1080 -> 3840x2160), with gamma's polynomial at each
// staging, and a step waits for its image rows, issued only one step
// ahead, at a barrier.  Per block the work is K1 split vh's (the same
// 64 x 128 tiles over the same ranges), and so is the time.
//
// Built without --use_fast_math: the epilogue's division, square roots
// and rounding stay IEEE.
//
// Tolerance: tensor-core sums of exact products are f32 in the hardware's
// order and rounding, so the kernel is within the split gate of its plain
// version (f32 within max|plain| * 1e-4; integers within 1 LSB, or one
// step with trunc_bits, plus one step where gamma-out amplifies it).  A
// split2 second pass multiplies the intermediate's bf16 hi part alone,
// and the two orders can round an intermediate element to hi parts one
// bf16 ulp apart, which no lo part takes up: f32 output there is within
// the split gate plus one ulp of the largest intermediate times the H
// taps' largest absolute column sum (chip_smoke.py:_planar_tol; at
// 259x37 -> 29x29 u8 it differed by 2.1e-4 x max|plain| on an H100).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "k1_common.cuh"
#include "mma_bf16.cuh"
#include "pack4.cuh"

namespace {

using namespace cp_async;
using namespace mma_bf16;

constexpr int kThreads = 256;        // 8 warps
constexpr int kRows = 64;            // output rows per block (planar.py: ROWS)
constexpr int kLanes = 128;          // output pixels per block (one chunk)
constexpr int kDepth = 32;           // contraction elements per step
constexpr int kTapLd = kDepth + 8;   // V-tap row stride in shared memory (bf16)
constexpr int kTileLd = kLanes + 8;  // 128-pixel tile row stride (bf16)
constexpr int kGroups = kDepth * kLanes / 4 / kThreads;  // 4-pixel groups a thread stages

struct Args {
  const void* x;
  int interleaved;          // K8's [rows, W*C] (else K7's [c*hp, wp] planes)
  int rows_in, lanes_in;    // extent of x
  int c, hp;                // channels; K7: row stride between planes
  void* out;
  int out_kind;             // 0 f32, 1 u8, 2 u16
  int out_lanes;
  const __nv_bfloat16* tvh;  // [Bv, Tv, Wv]
  const __nv_bfloat16* tvl;
  const int32_t* offs_v;    // [Bv]
  int bv, tv, wv;
  const __nv_bfloat16* thh;  // [Bh, n_ch, win_c, 128] dense H taps, chunked
  const __nv_bfloat16* thl;
  const int32_t* offs_l;    // [Bh] window starts, pixels
  const int32_t* rel;       // [n_ch]
  int n_ch, win_c, th;
  const int32_t* k_range;   // [Bv, n_slices, 2] nonzero V-tap rows of kRows-row slices, 32-aligned
  int n_slices;
  const int32_t* h_range;   // [Bh, n_ch, 2] nonzero H-tap rows, 32-aligned
  int alpha_in, alpha_out;  // channel bypassing the input / output curve, or -1
  int raw_ld;               // K8: row stride (bytes) of the raw span tile, or 0
  k1::Epilogue epi;         // alpha_lane 0: lane 0 bypasses the curves, lane 1 not
};

// Channel p of the image: pixel (r, w) at base[r * lanes_in + w * stride],
// zero at r >= rows or w >= pixels.
template <typename T>
struct Plane {
  const T* base;
  int rows, pixels, stride;
  bool vec;  // 4 pixels by one vector load: contiguous, rows and base 16-byte aligned

  __device__ Plane(const Args& a, int p) {
    const T* x = static_cast<const T*>(a.x);
    if (a.interleaved) {
      base = x + p;
      rows = a.rows_in;
      pixels = (a.lanes_in - p + a.c - 1) / a.c;
      stride = a.c;
    } else {
      base = x + static_cast<size_t>(p) * a.hp * a.lanes_in;
      rows = a.hp;
      pixels = a.lanes_in;
      stride = 1;
    }
    vec = stride == 1 && a.lanes_in % 4 == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;
  }
};

// Shared memory, in bf16 elements:
//   sv [2 buf][2 plane][kRows][kTapLd]  V taps (hi, lo)
//   sx [2 buf][2 plane][32][kTileLd]    image tile (first pass) or H taps
//                                        (second pass), hi / lo
//   si [2 plane][kRows][kTileLd]        intermediate hi / lo
// then, for K8's raw staging, the raw span tile [32 rows][raw_ld bytes].
struct Smem {
  static constexpr int kSv = 2 * 2 * kRows * kTapLd;
  static constexpr int kSx = 2 * 2 * kDepth * kTileLd;
  static constexpr int kSi = 2 * kRows * kTileLd;
  static constexpr size_t kBytes = static_cast<size_t>(kSv + kSx + kSi) * 2;
  __device__ static int sv(int b, int p, int r, int k) { return ((b * 2 + p) * kRows + r) * kTapLd + k; }
  __device__ static int sx(int b, int p, int r, int l) {
    return kSv + ((b * 2 + p) * kDepth + r) * kTileLd + l;
  }
  __device__ static int si(int p, int r, int l) { return kSv + kSx + (p * kRows + r) * kTileLd + l; }
};

template <bool S3V, bool GAMMA, typename TIn>
struct Stage {
  using S = Smem;
  using P = Pack4<TIn>;
  using Raw = typename P::type;

  // V taps of rows r0..r0+kRows-1 over k0..k0+31 into buffer b (rows past
  // the V block: zeros).
  __device__ static void stage_v(const Args& a, uint16_t* sm, int b, int vb, int r0, int k0) {
    for (int c = threadIdx.x; c < 2 * kRows * 4; c += kThreads) {
      const int p = c / (kRows * 4), r = (c / 4) % kRows, part = c % 4;
      const bool valid = r0 + r < a.tv;
      const size_t row = static_cast<size_t>(vb) * a.tv + (valid ? r0 + r : 0);
      cp16(sm + S::sv(b, p, r, part * 8), (p ? a.tvl : a.tvh) + row * a.wv + k0 + part * 8, valid);
    }
  }

  // Dense H taps of window pixels m0..m0+31 of chunk ``chunk`` into buffer b.
  __device__ static void stage_h(const Args& a, uint16_t* sm, int b, int chunk, int m0) {
    for (int c = threadIdx.x; c < 2 * kDepth * 16; c += kThreads) {
      const int p = c / (kDepth * 16), r = (c / 16) % kDepth, part = c % 16;
      const __nv_bfloat16* src =
          (p ? a.thl : a.thh) + (static_cast<size_t>(chunk) * a.win_c + m0 + r) * kLanes + part * 8;
      cp16(sm + S::sx(b, p, r, part * 8), src, true);
    }
  }

  // Plane rows row..row+31 over pixels px..px+w-1 (px a multiple of 4)
  // into registers, 4 pixels a group, zero past the plane's edge.
  __device__ static void load_x(const Args& a, const Plane<TIn>& pl, int row, int px, int w,
                                Raw (&raw)[kGroups]) {
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int q = threadIdx.x + i * kThreads;
      const int r = row + q / 32, l = 4 * (q % 32);
      const int n = (r < pl.rows && l < w) ? min(4, max(0, pl.pixels - px - l)) : 0;
      const TIn* ptr =
          pl.base + (n > 0 ? static_cast<size_t>(r) * a.lanes_in +
                                 static_cast<size_t>(px + l) * pl.stride
                           : 0);
      raw[i] = (pl.vec && n == 4) ? P::load(ptr) : P::gather(ptr, n, pl.stride);
    }
  }

  // K8's raw staging: the interleaved bytes of plane rows row..row+31 over
  // pixels px..px+w-1 (all channels), from the 16-byte boundary at or
  // before the first, by cp.async of 16-byte pieces into the raw tile
  // (zeros past the row's end and past the image's rows).  Returns that
  // boundary's byte offset in the row.
  __device__ static int stage_raw(const Args& a, uint8_t* raw, int row, int px, int w) {
    constexpr int kEs = static_cast<int>(sizeof(TIn));
    const int row_bytes = a.lanes_in * kEs;
    const int a0 = px * a.c * kEs / 16 * 16;
    const int n_pc = ((px + w) * a.c * kEs - a0 + 15) / 16;
    for (int c = threadIdx.x; c < 32 * n_pc; c += kThreads) {
      const int k = c / n_pc, off = a0 + 16 * (c % n_pc);
      const int r = row + k;
      const int n = r < a.rows_in ? max(0, min(16, row_bytes - off)) : 0;
      const uint8_t* src = static_cast<const uint8_t*>(a.x) +
                           (n > 0 ? static_cast<size_t>(r) * row_bytes + off : 0);
      cp16n(raw + k * a.raw_ld + (off - a0), src, n);
    }
    return a0;
  }

  // The raw tile's elements of channel p, pixels px..px+w-1 (its stride-C
  // de-interleave), converted, linearized and split into buffer b.
  __device__ static void convert_raw(const Args& a, uint16_t* sm, const uint8_t* raw, int a0,
                                     int p, int b, int px, int w, int lane) {
    constexpr int kEs = static_cast<int>(sizeof(TIn));
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int q = threadIdx.x + i * kThreads;
      const int k = q / 32, l = 4 * (q % 32);
      if (l >= w) continue;
      const uint8_t* src = raw + k * a.raw_ld + ((px + l) * a.c + p) * kEs - a0;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = static_cast<float>(*reinterpret_cast<const TIn*>(src + e * a.c * kEs));
        if (GAMMA) v[e] = k1::gamma_in(a.epi, v[e], lane);
      }
      uint2 hi, lo;
      split_pair(v[0], v[1], hi.x, lo.x);
      split_pair(v[2], v[3], hi.y, lo.y);
      *reinterpret_cast<uint2*>(sm + S::sx(b, 0, k, l)) = hi;
      if (S3V) *reinterpret_cast<uint2*>(sm + S::sx(b, 1, k, l)) = lo;
    }
  }

  // The registers of load_x converted, linearized (``lane``: 0 for the
  // alpha channel, 1 otherwise) and split into buffer b.
  __device__ static void store_x(const Args& a, uint16_t* sm, int b, int w, int lane,
                                 const Raw (&raw)[kGroups]) {
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int q = threadIdx.x + i * kThreads;
      const int k = q / 32, l = 4 * (q % 32);
      if (l >= w) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = P::get(raw[i], e);
        if (GAMMA) v[e] = k1::gamma_in(a.epi, v[e], lane);
      }
      uint2 hi, lo;
      split_pair(v[0], v[1], hi.x, lo.x);
      split_pair(v[2], v[3], hi.y, lo.y);
      *reinterpret_cast<uint2*>(sm + S::sx(b, 0, k, l)) = hi;
      if (S3V) *reinterpret_cast<uint2*>(sm + S::sx(b, 1, k, l)) = lo;
    }
  }
};

template <bool GAMMA>
__device__ __forceinline__ void store_one(const Args& a, size_t i, float v, int lane) {
  if (a.out_kind == 0) {
    static_cast<float*>(a.out)[i] = k1::finish_float<GAMMA>(a.epi, v, lane);
    return;
  }
  const int q = static_cast<int>(k1::finish_int<GAMMA>(a.epi, v, lane));
  if (a.out_kind == 1) {
    static_cast<uint8_t*>(a.out)[i] = static_cast<uint8_t>(q);
  } else {
    static_cast<uint16_t*>(a.out)[i] = static_cast<uint16_t>(q);
  }
}

// One block: output rows r0..r0+kRows-1 of V block vb (slice ``slice``) x the
// 128 pixels of chunk j of H block hb, of channel p.  The work is one
// sequence of 32-deep steps: per window segment, the first pass's steps
// over k_range (V taps x image tile into the accumulators m, which the
// segment's last such step splits into the intermediate tile) and then the
// second pass's steps over the segment's pixels (intermediate x H taps
// into acc).  While a step's MMAs run, the next step's taps are on their
// way by cp.async and its image rows in registers, into the other buffer.
template <bool S3V, bool S3H, bool GAMMA, typename TIn>
__global__ void __launch_bounds__(kThreads, 2) planar_mma(const Args a) {
  using K = Stage<S3V, GAMMA, TIn>;
  using S = Smem;
  constexpr int kWm = kRows / 16;        // warps across rows
  constexpr int kWn = 8 / kWm;       // warps across pixels
  constexpr int kWc = kLanes / kWn;  // pixels a warp
  constexpr int kNt = kWc / 8;       // n8 tiles a warp
  extern __shared__ __align__(16) uint16_t sm[];

  const int p = blockIdx.x % a.c;
  const int chunk = blockIdx.x / a.c;
  const int hb = chunk / a.n_ch, j = chunk % a.n_ch;
  const int vb = blockIdx.y / a.n_slices, slice = blockIdx.y % a.n_slices;
  const int r0 = slice * kRows;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int wm = warp / kWn, wn = warp % kWn;
  const int arow = lid & 15, acol = (lid >> 4) * 8;  // ldmatrix address of this thread
  const int g = lid / 4, t = lid % 4;                // accumulator row / pixel pair
  const int k_lo = a.k_range[2 * blockIdx.y];
  const int k_hi = a.k_range[2 * blockIdx.y + 1];
  const int h_lo = a.h_range[2 * chunk];
  const int h_hi = a.h_range[2 * chunk + 1];
  const int row0 = a.offs_v[vb] + k_lo;
  const int px0 = a.offs_l[hb] + a.rel[j];
  const int nv = (k_hi - k_lo) / kDepth;  // first-pass steps per segment
  const int lim = a.th - j * kLanes;      // chunk pixels that are output
  const Plane<TIn> pl(a, p);
  const int lane_in = p == a.alpha_in ? 0 : 1;
  // K8 with a raw span tile: the image comes by cp.async, not registers.
  const bool by_raw = a.raw_ld > 0;
  uint8_t* rt = reinterpret_cast<uint8_t*>(sm) + S::kBytes;

  float acc[kNt][4] = {};
  // No nonzero V tap or H tap: the block's sums are 0.
  if (nv > 0 && h_lo < h_hi) {
    float m[kNt][4] = {};
    typename K::Raw raw[kGroups];
    int seg = h_lo, i = 0, b = 0, a0 = 0;
    K::stage_v(a, sm, 0, vb, r0, k_lo);
    if (by_raw) a0 = K::stage_raw(a, rt, row0, px0 + seg, min(kLanes, h_hi - seg));
    cp_commit();
    if (!by_raw) {
      K::load_x(a, pl, row0, px0 + seg, min(kLanes, h_hi - seg), raw);
      K::store_x(a, sm, 0, min(kLanes, h_hi - seg), lane_in, raw);
    }
    cp_wait_all();
    __syncthreads();
    if (by_raw) {
      K::convert_raw(a, sm, rt, a0, p, 0, px0 + seg, min(kLanes, h_hi - seg), lane_in);
      __syncthreads();
    }
    while (true) {
      const int w = min(kLanes, h_hi - seg);  // a multiple of 32
      // The next step: (nseg, ni), ni < nv a first-pass step.
      int nseg = seg, ni = i + 1;
      if (ni == nv + w / kDepth) {
        nseg = seg + kLanes;
        ni = 0;
      }
      const bool more = nseg < h_hi;
      const int nw = min(kLanes, h_hi - nseg);
      if (more) {
        if (ni < nv) {
          K::stage_v(a, sm, b ^ 1, vb, r0, k_lo + ni * kDepth);
          if (by_raw) a0 = K::stage_raw(a, rt, row0 + ni * kDepth, px0 + nseg, nw);
          cp_commit();
          if (!by_raw) K::load_x(a, pl, row0 + ni * kDepth, px0 + nseg, nw, raw);
        } else {
          K::stage_h(a, sm, b ^ 1, chunk, nseg + (ni - nv) * kDepth);
          cp_commit();
        }
      }
      if (i < nv) {
        // ---- first (vertical) pass step ------------------------------
#pragma unroll
        for (int k16 = 0; k16 < kDepth; k16 += 16) {
          uint32_t th[4], tl[4];
          ldsm(th, sm + S::sv(b, 0, 16 * wm + arow, k16 + acol));
          ldsm(tl, sm + S::sv(b, 1, 16 * wm + arow, k16 + acol));
#pragma unroll
          for (int q = 0; q < kNt / 2; ++q) {
            const int n0 = kWc * wn + 16 * q;
            if (n0 >= w) continue;
            uint32_t xh[4];
            ldsm_t(xh, sm + S::sx(b, 0, k16 + arow, n0 + acol));
            mma(m[2 * q], th, xh[0], xh[1]);
            mma(m[2 * q + 1], th, xh[2], xh[3]);
            mma(m[2 * q], tl, xh[0], xh[1]);
            mma(m[2 * q + 1], tl, xh[2], xh[3]);
            if (S3V) {
              uint32_t xl[4];
              ldsm_t(xl, sm + S::sx(b, 1, k16 + arow, n0 + acol));
              mma(m[2 * q], th, xl[0], xl[1]);
              mma(m[2 * q + 1], th, xl[2], xl[3]);
            }
          }
        }
        if (i == nv - 1) {
          // The segment's intermediate, split into shared memory (the
          // last second-pass step before ended with a barrier).
#pragma unroll
          for (int n = 0; n < kNt; ++n) {
            const int col = kWc * wn + 8 * n + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 16 * wm + g + 8 * h;
              uint32_t hi, lo;
              split_pair(m[n][2 * h], m[n][2 * h + 1], hi, lo);
              *reinterpret_cast<uint32_t*>(sm + S::si(0, r, col)) = hi;
              if (S3H) *reinterpret_cast<uint32_t*>(sm + S::si(1, r, col)) = lo;
              m[n][2 * h] = 0.0f;
              m[n][2 * h + 1] = 0.0f;
            }
          }
        }
      } else {
        // ---- second (horizontal) pass step ---------------------------
        const int kk = (i - nv) * kDepth;
#pragma unroll
        for (int k16 = 0; k16 < kDepth; k16 += 16) {
          uint32_t ih[4], il[4];
          ldsm(ih, sm + S::si(0, 16 * wm + arow, kk + k16 + acol));
          if (S3H) ldsm(il, sm + S::si(1, 16 * wm + arow, kk + k16 + acol));
#pragma unroll
          for (int q = 0; q < kNt / 2; ++q) {
            const int n0 = kWc * wn + 16 * q;
            if (n0 >= lim) continue;  // pixels past the chunk's last output
            uint32_t hh[4], hl[4];
            ldsm_t(hh, sm + S::sx(b, 0, k16 + arow, n0 + acol));
            ldsm_t(hl, sm + S::sx(b, 1, k16 + arow, n0 + acol));
            mma(acc[2 * q], ih, hh[0], hh[1]);
            mma(acc[2 * q + 1], ih, hh[2], hh[3]);
            mma(acc[2 * q], ih, hl[0], hl[1]);
            mma(acc[2 * q + 1], ih, hl[2], hl[3]);
            if (S3H) {
              mma(acc[2 * q], il, hh[0], hh[1]);
              mma(acc[2 * q + 1], il, hh[2], hh[3]);
            }
          }
        }
      }
      if (more) {
        if (ni < nv && !by_raw) K::store_x(a, sm, b ^ 1, nw, lane_in, raw);
        cp_wait_all();
        if (ni < nv && by_raw) {
          // Every thread's pieces have landed; then the de-interleave.
          __syncthreads();
          K::convert_raw(a, sm, rt, a0, p, b ^ 1, px0 + nseg, nw, lane_in);
        }
      }
      __syncthreads();
      if (!more) break;
      seg = nseg;
      i = ni;
      b ^= 1;
    }
  }

  // ---- epilogue: accumulator (row g (+8), pixels 2t, 2t+1) -> output ---
  const int lane_out = p == a.alpha_out ? 0 : 1;
  const size_t row_base = static_cast<size_t>(a.interleaved ? 0 : p * a.bv * a.tv) + vb * a.tv;
  const int col_base = (a.interleaved ? hb * a.c + p : hb) * a.th + j * kLanes;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tr = r0 + 16 * wm + g + 8 * h;
    if (tr >= a.tv) continue;
    const size_t o = (row_base + tr) * a.out_lanes + col_base;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = kWc * wn + 8 * n + 2 * t + e;
        if (cl < lim) store_one<GAMMA>(a, o + cl, acc[n][2 * h + e], lane_out);
      }
    }
  }
}

template <bool S3V, bool S3H, bool GAMMA, typename TIn>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t s) {
  const size_t bytes = Smem::kBytes + static_cast<size_t>(32) * a.raw_ld;
  cudaError_t e = cudaFuncSetAttribute(planar_mma<S3V, S3H, GAMMA, TIn>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  planar_mma<S3V, S3H, GAMMA, TIn><<<grid, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <bool S3V, bool S3H, bool GAMMA>
cudaError_t launch_in(int in_kind, const Args& a, dim3 grid, cudaStream_t s) {
  if (in_kind == 0) return launch<S3V, S3H, GAMMA, uint8_t>(a, grid, s);
  if (in_kind == 1) return launch<S3V, S3H, GAMMA, uint16_t>(a, grid, s);
  return launch<S3V, S3H, GAMMA, float>(a, grid, s);
}

template <bool GAMMA>
cudaError_t launch_modes(bool s3v, bool s3h, int in_kind, const Args& a, dim3 grid,
                         cudaStream_t s) {
  if (s3v) {
    return s3h ? launch_in<true, true, GAMMA>(in_kind, a, grid, s)
               : launch_in<true, false, GAMMA>(in_kind, a, grid, s);
  }
  return s3h ? launch_in<false, true, GAMMA>(in_kind, a, grid, s)
             : launch_in<false, false, GAMMA>(in_kind, a, grid, s);
}

}  // namespace

extern "C" int avir_planar(
    const void* x, void* out, int in_kind, int rows_in, int lanes_in, int raw_ld, void* stream,
    int interleaved, int split3_v, int split3_h, int out_kind,
    int c, int hp, int out_lanes,
    const void* tvh, const void* tvl, const void* offs_v,
    int bv, int tv, int wv,
    const void* thh, const void* thl, const void* offs_l, const void* rel,
    int bh, int n_ch, int win_c, int th,
    const void* k_range, int n_slices, const void* h_range,
    float out_max, float tm, int trunc_bits,
    int gamma, int alpha_in, int alpha_out, float in_gamma_mult, float out_gamma_mult,
    float scale, int even) {
  if (n_slices != (tv + kRows - 1) / kRows || win_c % kDepth != 0 ||
      static_cast<long long>(bv) * n_slices > 65535 || raw_ld % 16 != 0 ||
      (raw_ld > 0 && !interleaved)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = x;
  a.interleaved = interleaved;
  a.rows_in = rows_in;
  a.lanes_in = lanes_in;
  a.c = c;
  a.hp = hp;
  a.out = out;
  a.out_kind = out_kind;
  a.out_lanes = out_lanes;
  a.tvh = static_cast<const __nv_bfloat16*>(tvh);
  a.tvl = static_cast<const __nv_bfloat16*>(tvl);
  a.offs_v = static_cast<const int32_t*>(offs_v);
  a.bv = bv;
  a.tv = tv;
  a.wv = wv;
  a.thh = static_cast<const __nv_bfloat16*>(thh);
  a.thl = static_cast<const __nv_bfloat16*>(thl);
  a.offs_l = static_cast<const int32_t*>(offs_l);
  a.rel = static_cast<const int32_t*>(rel);
  a.n_ch = n_ch;
  a.win_c = win_c;
  a.th = th;
  a.k_range = static_cast<const int32_t*>(k_range);
  a.n_slices = n_slices;
  a.h_range = static_cast<const int32_t*>(h_range);
  a.alpha_in = alpha_in;
  a.alpha_out = alpha_out;
  a.raw_ld = raw_ld;
  a.epi.alpha_lane = 0;
  a.epi.in_gamma_mult = in_gamma_mult;
  a.epi.out_gamma_mult = out_gamma_mult;
  a.epi.scale = scale;
  a.epi.even = even;
  a.epi.trunc_bits = trunc_bits;
  a.epi.tm = tm;
  a.epi.out_max = out_max;
  const dim3 grid(bh * n_ch * c, bv * n_slices);
  if (grid.x == 0 || grid.y == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = gamma ? launch_modes<true>(split3_v, split3_h, in_kind, a, grid, s)
                               : launch_modes<false>(split3_v, split3_h, in_kind, a, grid, s);
  return static_cast<int>(e);
}
