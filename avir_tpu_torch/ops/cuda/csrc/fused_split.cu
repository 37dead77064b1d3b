// Fused two-pass split-bf16 resize (K1, split2/split3 modes) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// avir_tpu/ops/pallas/fused_kernel.py: apply_fused_pallas -> _kernel
// (float branch) -> _rmul -> _finish, with its epilogue options (biased
// or round-half-even rounding, LANCIR's output ``scale``) and its
// in-kernel sRGB gamma stages (the degree-9 linearization as the input
// tile is staged, _linear_to_srgb before the epilogue, the C=4 alpha
// bypass; k1_common.cuh).  One launch computes the whole separable resize
// [rows_in, lanes_in] (u8, u16 or f32) -> [rows_out, lanes_out] (f32, u8
// or u16) from the error-free bf16 hi/lo tap splits; the float32
// intermediate lives only on chip.
//
// Arithmetic (the same function as the TPU kernel, summed in another
// order, so equal to float32 rounding and not bit for bit):
//   input       u8/u16 -> f32 exactly; gamma (GAMMA): x = poly9(x *
//               in_gamma_mult) (the alpha lane: x * in_gamma_mult);
//               split x = hi + lo with hi = bf16(x), lo = bf16(x - hi);
//               reads past the edge see 0.
//   a pass      split2: sum t_hi*x_hi + t_lo*x_hi
//               split3: ... + t_hi*x_lo
//               every product is bf16 x bf16, exact in f32; sums are f32.
//   between     the f32 intermediate is split the same way.
//   epilogue    gamma: v = linear_to_srgb(v) * out_gamma_mult.
//               f32 out: store.  Integer out: v *= scale (when != 1);
//               v = floor(v + 0.5), rint(v) (round_mode "even"), or
//               floor(v / tm + 0.5) * tm when trunc_bits > 0 (IEEE
//               division); clamp to [0, out_max]; truncate to u8/u16.
//
// vh (V pass first; every split resize but rule 4's u8 upsizes).  Both
// passes run on the bf16 tensor cores: mma.sync m16n8k16 (row.col, f32
// accumulate) on fragments that ldmatrix reads from shared memory (.trans
// for the [K, N] operands).  The two or three split products of a pass
// are consecutive MMAs into one accumulator.  A block owns 64 output rows
// (a slice of one V block) and one 128-lane output chunk of one lane
// block, with 8 warps: warp (wm, wn) owns rows 16 wm..16 wm + 15 and lanes
// 64 wn..64 wn + 63 of each tile.  For each segment of up to 128 window
// lanes, from the chunk's nonzero lane-tap range (h_range, 32-aligned) in
// widths of 32 (warps skip 16-lane tiles past the segment's end):
//   - first pass over the slice's nonzero V-tap rows (k_range), 32 a
//     step: the V taps (bf16, as stored) come by cp.async, the image rows
//     by vector loads into registers; the image is converted to f32 (the
//     input type is a template parameter), linearized with gamma, and
//     split into bf16 hi/lo planes once per staged element;
//   - the segment's last first-pass step splits the accumulators into a
//     bf16 hi/lo intermediate tile in shared memory.  Not straight into
//     the second pass's A fragments: a warp's second pass reads all the
//     segment's lanes of its rows, which two warps computed, so registers
//     alone would leave half the warps idle in the first pass or need a
//     cross-warp sum of the outputs;
//   - second pass: the segment's lane taps (bf16, 32 window lanes a
//     step, cp.async) times the intermediate, into the block's output
//     accumulators.
// The fragment, copy and image-packing helpers come from mma_bf16.cuh,
// cp_async.cuh and pack4.cuh (shared with planar.cu).  All steps of both
// passes and all segments form one sequence with double buffers: while a
// step's MMAs run, the next step's taps are in flight by cp.async and its
// image rows in registers.  64 rows a block (not 32 or
// 128, which were tried): a taller slice stages fewer image elements per
// output (every block whose window covers an input element recomputes the
// first pass over it) but multiplies a larger dense V block, and 128 rows
// spill at the register budget of a full SM.  Shared-memory rows are
// padded (V taps to 40 bf16, the 128-lane tiles to 136) so that the 8
// rows of each ldmatrix phase fall in distinct banks; every tap row starts
// 16-byte aligned (Wv and the lane-tap rows are multiples of 128 taps,
// k_range and h_range multiples of 32), so the taps need no host padding.
// 90,112 B of shared memory and at most 128 registers (ptxas, printed by
// chip_smoke.py: no spills but 4-12 bytes in three u8 variants), so two
// blocks (16 warps) an SM.
//
// What bounds it on this card.  The image read once, the output written
// once and the taps bound it at tens of microseconds at the main-path
// sizes (bytes, 3.35 TB/s); the dense MACs over the tap blocks (what the
// MMAs issue) take tens of microseconds at the bf16 tensor-core rate.
// What sets the pace now is the staging: each block converts and splits
// its window of the image, so an input element is staged as often as the
// first-pass recompute reads it (chip_smoke.py prints the factor, 1.8-8.8
// at the main-path cells), with gamma's polynomial at each staging, and
// each step waits on one barrier.  wgmma, TMA and a first-pass
// intermediate shared across chunks are the next ways down (PERF.md).
//
// Tolerance: tensor-core sums of exact products are f32 in the hardware's
// order and rounding, so the kernel is within the split gate of its plain
// version (f32 within max|plain| * 1e-4; integers within 1 LSB, or one
// step with trunc_bits, plus one step where a scale > 1 or gamma-out
// amplifies it), not bit-equal.
//
// hv (H pass first: u8 upsizes with a split2 first pass, no gamma and at
// least 8 M output values, runtime.choose_fused rule 4).  The same
// building blocks in the H-first roles, 8 warps, a block owning 64 output
// rows (kHvRows) x one 128-lane chunk.  For each 32-row group of the
// slice's nonzero V-tap rows (k_range at 64-row slices):
//   - first pass, 32 window lanes a step over the chunk's nonzero lane
//     taps (h_range): F[32 rows][128 lanes] += X[32][32] H[32][128], A
//     the image tile (converted, linearized with gamma and split into
//     bf16 hi/lo once per staged element, read by ldmatrix), B the lane
//     taps (cp.async, ldmatrix.trans; b16 has the .trans form, so nothing
//     is stored transposed as in fused_int8.cu's hv); warps 2 x 4 of 16
//     rows x 32 lanes;
//   - the group's last first-pass step splits F into a bf16 hi/lo tile in
//     shared memory;
//   - second pass, one step: out[64][128] += V[64][32] F[32][128], A the
//     group's V taps as stored, B the F tile (ldmatrix.trans); warps 4 x
//     2 of 16 rows x 64 lanes.
// The intermediate is one [32][128] tile however tall the window, so the
// window height has no limit.  All steps form one double-buffered
// sequence as in vh (the V taps in one buffer).  71 KB of shared memory
// and 128 registers without spills, two blocks an SM.  64 rows, not 32 or
// 128 (split_hv_heights.py): 128-row blocks hold 64 accumulators a thread
// and spill at 128 registers; they ran 9% faster at 1080p -> 4K errdiff
// and 30% slower with gamma.  What bounds it: the image read once and the
// float32 output written once (32 us at 1080p -> 4K), the dense MACs over
// the tap blocks about as long at the bf16 rate; what sets the pace is the
// step sequence (a first-pass step holds half a vh step's MMAs, and each
// ends at a barrier) and the image staged once per block whose window
// covers it (chip_smoke.py prints the factor).
//
// With gamma the polynomial runs on every staged input element and the
// square roots once per output.  Built without --use_fast_math: the
// division, the square roots and the rounding of the epilogue stay IEEE.

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

constexpr int kLanes = 128;  // output lanes per block (one chunk)
constexpr int kDepth = 32;   // contraction elements staged per step

struct Args {
  const void* x;
  int in_kind;              // 0 u8, 1 u16, 2 f32
  int rows_in, lanes_in;
  void* out;
  int out_kind;             // 0 f32, 1 u8, 2 u16
  int rows_out, lanes_out;
  const __nv_bfloat16* tvh;  // [Bv, Tv, Wv]
  const __nv_bfloat16* tvl;
  const int32_t* offs_v;    // [Bv]
  int tv, wv;
  const __nv_bfloat16* thh;  // [Bh, n_ch, win_c, 128]
  const __nv_bfloat16* thl;
  const int32_t* offs_l;    // [Bh]
  const int32_t* rel;       // [n_ch]
  int n_ch, win_c, tc;
  const int32_t* k_range;   // [Bv, n_slices, 2] nonzero V-tap rows, 32-aligned
  int n_slices;
  const int32_t* h_range;   // [Bh, n_ch, 2] nonzero lane-tap rows, 32-aligned
  k1::Epilogue epi;
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

// ---------------------------------------------------------------------------
// vh: tensor-core building blocks
// ---------------------------------------------------------------------------

constexpr int kVhRows = 64;          // output rows per vh block (R)
constexpr int kVhThreads = 256;      // 8 warps: 4 (rows) x 2 (lanes)
constexpr int kTapLd = kDepth + 8;   // V-tap row stride in shared memory (bf16)
constexpr int kTileLd = kLanes + 8;  // 128-lane tile row stride (bf16)

// Shared memory of the vh kernel, in bf16 elements:
//   sv [2 buf][2 plane][R][kTapLd]      V taps (hi, lo)
//   sx [2 buf][2 plane][32][kTileLd]    image tile (first pass) or lane
//                                        taps (second pass), hi / lo
//   si [2 plane][R][kTileLd]            intermediate hi / lo
struct VhSmem {
  static constexpr int kSv = 2 * 2 * kVhRows * kTapLd;
  static constexpr int kSx = 2 * 2 * kDepth * kTileLd;
  static constexpr int kSi = 2 * kVhRows * kTileLd;
  static constexpr size_t kBytes = static_cast<size_t>(kSv + kSx + kSi) * 2;
  __device__ static int sv(int b, int p, int r, int k) { return ((b * 2 + p) * kVhRows + r) * kTapLd + k; }
  __device__ static int sx(int b, int p, int r, int l) {
    return kSv + ((b * 2 + p) * kDepth + r) * kTileLd + l;
  }
  __device__ static int si(int p, int r, int l) { return kSv + kSx + (p * kVhRows + r) * kTileLd + l; }
};

template <bool S3V, bool S3H, bool GAMMA, typename TIn>
struct Vh {
  static constexpr int kNT = kVhThreads;
  static constexpr int kGroups = kDepth * kLanes / 4 / kNT;  // 4-lane image groups per thread
  using S = VhSmem;
  using P = Pack4<TIn>;
  using Raw = typename P::type;

  // V taps of rows r0..r0+R-1 over k0..k0+31 into buffer b (rows past
  // the V block: zeros).
  __device__ static void stage_v(const Args& a, uint16_t* sm, int b, int vb, int r0, int k0) {
    for (int c = threadIdx.x; c < 2 * kVhRows * 4; c += kNT) {
      const int p = c / (kVhRows * 4), r = (c / 4) % kVhRows, part = c % 4;
      const bool valid = r0 + r < a.tv;
      const size_t row = static_cast<size_t>(vb) * a.tv + (valid ? r0 + r : 0);
      const __nv_bfloat16* src = (p ? a.tvl : a.tvh) + row * a.wv + k0 + part * 8;
      cp16(sm + S::sv(b, p, r, part * 8), src, valid);
    }
  }

  // Lane taps of window rows m0..m0+31 of chunk ``chunk`` into buffer b.
  __device__ static void stage_h(const Args& a, uint16_t* sm, int b, int chunk, int m0) {
    for (int c = threadIdx.x; c < 2 * kDepth * 16; c += kNT) {
      const int p = c / (kDepth * 16), r = (c / 16) % kDepth, part = c % 16;
      const __nv_bfloat16* src =
          (p ? a.thl : a.thh) + (static_cast<size_t>(chunk) * a.win_c + m0 + r) * kLanes + part * 8;
      cp16(sm + S::sx(b, p, r, part * 8), src, true);
    }
  }

  // Image rows row..row+31 over lanes lane..lane+w-1 (lane a multiple of
  // 4) into registers, 4 lanes a group, zero past the edge.
  __device__ static void load_x(const Args& a, int row, int lane, int w, bool vec,
                                Raw (&raw)[kGroups]) {
    const TIn* x = static_cast<const TIn*>(a.x);
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int q = threadIdx.x + i * kNT;
      const int r = row + q / 32, l = 4 * (q % 32);
      const int n = (r < a.rows_in && l < w) ? min(4, max(0, a.lanes_in - lane - l)) : 0;
      const TIn* p = x + static_cast<size_t>(n > 0 ? r : 0) * a.lanes_in + lane + l;
      raw[i] = (vec && n == 4) ? P::load(p) : P::gather(p, n);
    }
  }

  // The registers of load_x converted, linearized and split into buffer b.
  __device__ static void store_x(const Args& a, uint16_t* sm, int b, int lane, int w,
                                 const Raw (&raw)[kGroups]) {
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int q = threadIdx.x + i * kNT;
      const int k = q / 32, l = 4 * (q % 32);
      if (l >= w) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = P::get(raw[i], e);
        if (GAMMA) v[e] = k1::gamma_in(a.epi, v[e], lane + l + e);
      }
      uint2 hi, lo;
      split_pair(v[0], v[1], hi.x, lo.x);
      split_pair(v[2], v[3], hi.y, lo.y);
      *reinterpret_cast<uint2*>(sm + S::sx(b, 0, k, l)) = hi;
      if (S3V) *reinterpret_cast<uint2*>(sm + S::sx(b, 1, k, l)) = lo;
    }
  }
};

// One block: output rows r0..r0+R-1 of V block vb (slice ``slice``) x
// the 128 lanes of chunk j of lane block hb.  The work is one sequence
// of 32-deep steps: per lane segment, the first pass's steps over k_range
// (V taps x image tile into the accumulators m, which the segment's last
// such step splits into the intermediate tile) and then the second
// pass's steps over the segment's lanes (intermediate x lane taps into
// acc).  While a step's MMAs run, the next step's taps are on their way
// by cp.async and its image rows in registers, into the other buffer.
template <bool S3V, bool S3H, bool GAMMA, typename TIn>
__global__ void __launch_bounds__(kVhThreads, 2) fused_split_vh(const Args a) {
  using K = Vh<S3V, S3H, GAMMA, TIn>;
  using S = VhSmem;
  extern __shared__ __align__(16) uint16_t sm[];

  const int chunk = blockIdx.x;
  const int hb = chunk / a.n_ch, j = chunk % a.n_ch;
  const int vb = blockIdx.y / a.n_slices, slice = blockIdx.y % a.n_slices;
  const int r0 = slice * kVhRows;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int arow = lid & 15, acol = (lid >> 4) * 8;  // ldmatrix address of this thread
  const int g = lid / 4, t = lid % 4;                // accumulator row / lane pair
  const int k_lo = a.k_range[2 * blockIdx.y];
  const int k_hi = a.k_range[2 * blockIdx.y + 1];
  const int h_lo = a.h_range[2 * chunk];
  const int h_hi = a.h_range[2 * chunk + 1];
  const int row0 = a.offs_v[vb] + k_lo;
  const int lane0 = a.offs_l[hb] + a.rel[j];
  const int nv = (k_hi - k_lo) / kDepth;  // first-pass steps per segment
  const bool vec = a.lanes_in % 4 == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;

  float acc[8][4] = {};
  // No nonzero V tap or lane tap: the block's sums are 0.
  if (nv > 0 && h_lo < h_hi) {
    float m[8][4] = {};
    typename K::Raw raw[K::kGroups];
    int seg = h_lo, i = 0, b = 0;
    K::stage_v(a, sm, 0, vb, r0, k_lo);
    cp_commit();
    K::load_x(a, row0, lane0 + seg, min(kLanes, h_hi - seg), vec, raw);
    K::store_x(a, sm, 0, lane0 + seg, min(kLanes, h_hi - seg), raw);
    cp_wait_all();
    __syncthreads();
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
          cp_commit();
          K::load_x(a, row0 + ni * kDepth, lane0 + nseg, nw, vec, raw);
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
          for (int q = 0; q < 4; ++q) {
            const int n0 = 64 * wn + 16 * q;
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
          for (int n = 0; n < 8; ++n) {
            const int col = 64 * wn + 8 * n + 2 * t;
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
          for (int q = 0; q < 4; ++q) {
            const int n0 = 64 * wn + 16 * q;
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
        if (ni < nv) K::store_x(a, sm, b ^ 1, lane0 + nseg, nw, raw);
        cp_wait_all();
      }
      __syncthreads();
      if (!more) break;
      seg = nseg;
      i = ni;
      b ^= 1;
    }
  }

  // ---- epilogue: accumulator (row g (+8), lanes 2t, 2t+1) -> output ---
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tr = r0 + 16 * wm + g + 8 * h;
    const int orow = vb * a.tv + tr;
    if (tr >= a.tv || orow >= a.rows_out) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = j * kLanes + 64 * wn + 8 * n + 2 * t + e;
        const int olane = hb * a.tc + cl;
        if (cl < a.tc && olane < a.lanes_out) {
          store_one<GAMMA>(a, static_cast<size_t>(orow) * a.lanes_out + olane,
                           acc[n][2 * h + e], olane);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// hv: the same building blocks in the H-first roles
// ---------------------------------------------------------------------------

constexpr int kHvRows = 64;  // output rows per hv block (R)
// Second-pass warp tiling: kHvWr x kHvWc warps, each 16 rows x kHvNi n8
// tiles of lanes.  The first pass ([32 window rows][128 lanes]) runs 2 x 4
// warps of 16 rows x 32 lanes.
constexpr int kHvWr = kHvRows / 16;
constexpr int kHvWc = 8 / kHvWr;
constexpr int kHvNi = kLanes / kHvWc / 8;
static_assert(kHvRows == 32 || kHvRows == 64 || kHvRows == 128, "8 warps of 16 rows or fewer");

// Shared memory of the hv kernel, in bf16 elements:
//   sx [2 buf][2 plane][32][kTapLd]     image tile: 32 window rows x 32
//                                        window lanes, hi / lo
//   sh [2 buf][2 plane][32][kTileLd]    lane taps: 32 window lanes x 128
//   sv [2 plane][R][kTapLd]             V taps of the group's 32 window rows
//   sf [2 plane][32][kTileLd]           the group's first-pass result, hi / lo
// sv needs one buffer: the step that stages it follows a first-pass step,
// and the step that read it before lies at least two barriers back.
struct HvSmem {
  static constexpr int kSx = 2 * 2 * kDepth * kTapLd;
  static constexpr int kSh = 2 * 2 * kDepth * kTileLd;
  static constexpr int kSv = 2 * kHvRows * kTapLd;
  static constexpr int kSf = 2 * kDepth * kTileLd;
  static constexpr size_t kBytes = static_cast<size_t>(kSx + kSh + kSv + kSf) * 2;
  __device__ static int sx(int b, int p, int r, int l) { return ((b * 2 + p) * kDepth + r) * kTapLd + l; }
  __device__ static int sh(int b, int p, int r, int l) {
    return kSx + ((b * 2 + p) * kDepth + r) * kTileLd + l;
  }
  __device__ static int sv(int p, int r, int k) { return kSx + kSh + (p * kHvRows + r) * kTapLd + k; }
  __device__ static int sf(int p, int r, int l) {
    return kSx + kSh + kSv + (p * kDepth + r) * kTileLd + l;
  }
};

template <bool S3H, bool GAMMA, typename TIn>
struct Hv {
  static constexpr int kNT = kVhThreads;
  using S = HvSmem;
  using P = Pack4<TIn>;
  using Raw = typename P::type;

  // Lane taps of window lanes m0..m0+31 of chunk ``chunk`` into buffer b.
  __device__ static void stage_h(const Args& a, uint16_t* sm, int b, int chunk, int m0) {
    for (int c = threadIdx.x; c < 2 * kDepth * 16; c += kNT) {
      const int p = c / (kDepth * 16), r = (c / 16) % kDepth, part = c % 16;
      const __nv_bfloat16* src =
          (p ? a.thl : a.thh) + (static_cast<size_t>(chunk) * a.win_c + m0 + r) * kLanes + part * 8;
      cp16(sm + S::sh(b, p, r, part * 8), src, true);
    }
  }

  // V taps of rows r0..r0+R-1 over window rows k0..k0+31 (rows past the
  // V block: zeros).
  __device__ static void stage_v(const Args& a, uint16_t* sm, int vb, int r0, int k0) {
    for (int c = threadIdx.x; c < 2 * kHvRows * 4; c += kNT) {
      const int p = c / (kHvRows * 4), r = (c / 4) % kHvRows, part = c % 4;
      const bool valid = r0 + r < a.tv;
      const size_t row = static_cast<size_t>(vb) * a.tv + (valid ? r0 + r : 0);
      const __nv_bfloat16* src = (p ? a.tvl : a.tvh) + row * a.wv + k0 + part * 8;
      cp16(sm + S::sv(p, r, part * 8), src, valid);
    }
  }

  // This thread's 4 lanes of the image tile rows row..row+31 x lanes
  // lane..lane+31 (lane a multiple of 4), zero past the edge.
  __device__ static Raw load_x(const Args& a, int row, int lane, bool vec) {
    const int r = row + threadIdx.x / 8, l = lane + 4 * (threadIdx.x % 8);
    const int n = r < a.rows_in ? min(4, max(0, a.lanes_in - l)) : 0;
    const TIn* p = static_cast<const TIn*>(a.x) + static_cast<size_t>(n > 0 ? r : 0) * a.lanes_in + l;
    return (vec && n == 4) ? P::load(p) : P::gather(p, n);
  }

  // The lanes of load_x converted, linearized and split into buffer b.
  __device__ static void store_x(const Args& a, uint16_t* sm, int b, int lane, const Raw& raw) {
    const int k = threadIdx.x / 8, l = 4 * (threadIdx.x % 8);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = P::get(raw, e);
      if (GAMMA) v[e] = k1::gamma_in(a.epi, v[e], lane + l + e);
    }
    uint2 hi, lo;
    split_pair(v[0], v[1], hi.x, lo.x);
    split_pair(v[2], v[3], hi.y, lo.y);
    *reinterpret_cast<uint2*>(sm + S::sx(b, 0, k, l)) = hi;
    if (S3H) *reinterpret_cast<uint2*>(sm + S::sx(b, 1, k, l)) = lo;
  }
};

// One block: output rows r0..r0+R-1 of V block vb (slice ``slice``) x
// the 128 lanes of chunk j of lane block hb.  For each 32-row group of
// the slice's nonzero V-tap rows (k_range), the first pass's steps over
// the chunk's nonzero lane taps (h_range, 32 window lanes a step: image
// tile x lane taps into the accumulators f, which the group's last such
// step splits into the intermediate tile), then one second-pass step
// (the group's V taps x the intermediate into acc).  One sequence of
// steps with double buffers, as in the vh kernel.
template <bool S3V, bool S3H, bool GAMMA, typename TIn>
__global__ void __launch_bounds__(kVhThreads, 2) fused_split_hv(const Args a) {
  using K = Hv<S3H, GAMMA, TIn>;
  using S = HvSmem;
  extern __shared__ __align__(16) uint16_t sm[];

  const int chunk = blockIdx.x;
  const int hb = chunk / a.n_ch, j = chunk % a.n_ch;
  const int vb = blockIdx.y / a.n_slices, slice = blockIdx.y % a.n_slices;
  const int r0 = slice * kHvRows;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int fm = warp / 4, fn = warp % 4;              // first pass: 16 rows x 32 lanes
  const int wm = warp / kHvWc, wn = warp % kHvWc;      // second pass
  const int arow = lid & 15, acol = (lid >> 4) * 8;  // ldmatrix address of this thread
  const int g = lid / 4, t = lid % 4;                // accumulator row / lane pair
  const int k_lo = a.k_range[2 * blockIdx.y];
  const int k_hi = a.k_range[2 * blockIdx.y + 1];
  const int h_lo = a.h_range[2 * chunk];
  const int h_hi = a.h_range[2 * chunk + 1];
  const int row0 = a.offs_v[vb] + k_lo;
  const int lane0 = a.offs_l[hb] + a.rel[j] + h_lo;
  const int ng = (k_hi - k_lo) / kDepth;  // 32-row groups
  const int nh = (h_hi - h_lo) / kDepth;  // first-pass steps per group
  const bool vec = a.lanes_in % 4 == 0 && (reinterpret_cast<uintptr_t>(a.x) & 15) == 0;

  float acc[kHvNi][4] = {};
  // No nonzero V tap or lane tap: the block's sums are 0.
  if (ng > 0 && nh > 0) {
    typename K::Raw raw;
    int b = 0;
    K::stage_h(a, sm, 0, chunk, h_lo);
    cp_commit();
    raw = K::load_x(a, row0, lane0, vec);
    K::store_x(a, sm, 0, lane0, raw);
    cp_wait_all();
    __syncthreads();
    for (int grp = 0; grp < ng; ++grp) {
      float f[4][4] = {};
      for (int i = 0; i < nh; ++i) {
        // The next step: the group's next first-pass step, else its
        // second-pass step.
        if (i + 1 < nh) {
          K::stage_h(a, sm, b ^ 1, chunk, h_lo + (i + 1) * kDepth);
          cp_commit();
          raw = K::load_x(a, row0 + grp * kDepth, lane0 + (i + 1) * kDepth, vec);
        } else {
          K::stage_v(a, sm, vb, r0, k_lo + grp * kDepth);
          cp_commit();
        }
        // ---- first (horizontal) pass step ------------------------------
#pragma unroll
        for (int k16 = 0; k16 < kDepth; k16 += 16) {
          uint32_t xh[4], xl[4];
          ldsm(xh, sm + S::sx(b, 0, 16 * fm + arow, k16 + acol));
          if (S3H) ldsm(xl, sm + S::sx(b, 1, 16 * fm + arow, k16 + acol));
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int n0 = 32 * fn + 16 * q;
            uint32_t hh[4], hl[4];
            ldsm_t(hh, sm + S::sh(b, 0, k16 + arow, n0 + acol));
            ldsm_t(hl, sm + S::sh(b, 1, k16 + arow, n0 + acol));
            mma(f[2 * q], xh, hh[0], hh[1]);
            mma(f[2 * q + 1], xh, hh[2], hh[3]);
            mma(f[2 * q], xh, hl[0], hl[1]);
            mma(f[2 * q + 1], xh, hl[2], hl[3]);
            if (S3H) {
              mma(f[2 * q], xl, hh[0], hh[1]);
              mma(f[2 * q + 1], xl, hh[2], hh[3]);
            }
          }
        }
        if (i + 1 < nh) {
          K::store_x(a, sm, b ^ 1, lane0 + (i + 1) * kDepth, raw);
        } else {
          // The group's intermediate, split into shared memory (the
          // second-pass step before ended with a barrier).
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col = 32 * fn + 8 * n + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t hi, lo;
              split_pair(f[n][2 * h], f[n][2 * h + 1], hi, lo);
              *reinterpret_cast<uint32_t*>(sm + S::sf(0, 16 * fm + g + 8 * h, col)) = hi;
              if (S3V) *reinterpret_cast<uint32_t*>(sm + S::sf(1, 16 * fm + g + 8 * h, col)) = lo;
            }
          }
        }
        cp_wait_all();
        __syncthreads();
        b ^= 1;
      }
      // ---- second (vertical) pass step: the group's share ----------------
      const bool more = grp + 1 < ng;
      if (more) {
        K::stage_h(a, sm, b ^ 1, chunk, h_lo);
        cp_commit();
        raw = K::load_x(a, row0 + (grp + 1) * kDepth, lane0, vec);
      }
#pragma unroll
      for (int k16 = 0; k16 < kDepth; k16 += 16) {
        uint32_t th[4], tl[4];
        ldsm(th, sm + S::sv(0, 16 * wm + arow, k16 + acol));
        ldsm(tl, sm + S::sv(1, 16 * wm + arow, k16 + acol));
#pragma unroll
        for (int q = 0; q < kHvNi / 2; ++q) {
          const int n0 = 8 * kHvNi * wn + 16 * q;
          uint32_t fh[4], fl[4];
          ldsm_t(fh, sm + S::sf(0, k16 + arow, n0 + acol));
          if (S3V) ldsm_t(fl, sm + S::sf(1, k16 + arow, n0 + acol));
          mma(acc[2 * q], th, fh[0], fh[1]);
          mma(acc[2 * q + 1], th, fh[2], fh[3]);
          mma(acc[2 * q], tl, fh[0], fh[1]);
          mma(acc[2 * q + 1], tl, fh[2], fh[3]);
          if (S3V) {
            mma(acc[2 * q], th, fl[0], fl[1]);
            mma(acc[2 * q + 1], th, fl[2], fl[3]);
          }
        }
      }
      if (more) {
        K::store_x(a, sm, b ^ 1, lane0, raw);
        cp_wait_all();
      }
      __syncthreads();
      b ^= 1;
    }
  }

  // ---- epilogue: accumulator (row g (+8), lanes 2t, 2t+1) -> output ---
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tr = r0 + 16 * wm + g + 8 * h;
    const int orow = vb * a.tv + tr;
    if (tr >= a.tv || orow >= a.rows_out) continue;
#pragma unroll
    for (int n = 0; n < kHvNi; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = j * kLanes + 8 * kHvNi * wn + 8 * n + 2 * t + e;
        const int olane = hb * a.tc + cl;
        if (cl < a.tc && olane < a.lanes_out) {
          store_one<GAMMA>(a, static_cast<size_t>(orow) * a.lanes_out + olane,
                           acc[n][2 * h + e], olane);
        }
      }
    }
  }
}

template <bool S3V, bool S3H, bool GAMMA, typename TIn>
cudaError_t launch_vh(const Args& a, dim3 grid, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_split_vh<S3V, S3H, GAMMA, TIn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(VhSmem::kBytes));
  if (e != cudaSuccess) return e;
  fused_split_vh<S3V, S3H, GAMMA, TIn><<<grid, kVhThreads, VhSmem::kBytes, s>>>(a);
  return cudaGetLastError();
}

template <bool S3V, bool S3H, bool GAMMA, typename TIn>
cudaError_t launch_hv(const Args& a, dim3 grid, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_split_hv<S3V, S3H, GAMMA, TIn>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(HvSmem::kBytes));
  if (e != cudaSuccess) return e;
  fused_split_hv<S3V, S3H, GAMMA, TIn><<<grid, kVhThreads, HvSmem::kBytes, s>>>(a);
  return cudaGetLastError();
}

// k_range comes over the order's slices: kVhRows rows for vh, kHvRows for
// hv.
template <bool S3V, bool S3H, bool GAMMA>
cudaError_t launch(bool hv, const Args& a, dim3 grid, cudaStream_t s) {
  if (a.n_slices != (a.tv + (hv ? kHvRows : kVhRows) - 1) / (hv ? kHvRows : kVhRows)) {
    return cudaErrorInvalidValue;
  }
  if (hv) {
    if (a.in_kind == 0) return launch_hv<S3V, S3H, GAMMA, uint8_t>(a, grid, s);
    if (a.in_kind == 1) return launch_hv<S3V, S3H, GAMMA, uint16_t>(a, grid, s);
    return launch_hv<S3V, S3H, GAMMA, float>(a, grid, s);
  }
  if (a.in_kind == 0) return launch_vh<S3V, S3H, GAMMA, uint8_t>(a, grid, s);
  if (a.in_kind == 1) return launch_vh<S3V, S3H, GAMMA, uint16_t>(a, grid, s);
  return launch_vh<S3V, S3H, GAMMA, float>(a, grid, s);
}

template <bool GAMMA>
cudaError_t launch_modes(bool hv, bool s3v, bool s3h, const Args& a, dim3 grid,
                         cudaStream_t s) {
  if (s3v) {
    return s3h ? launch<true, true, GAMMA>(hv, a, grid, s)
               : launch<true, false, GAMMA>(hv, a, grid, s);
  }
  return s3h ? launch<false, true, GAMMA>(hv, a, grid, s)
             : launch<false, false, GAMMA>(hv, a, grid, s);
}

}  // namespace

extern "C" int avir_fused_split(
    const void* x, void* out, int in_kind, void* stream,
    int hv, int split3_v, int split3_h, int out_kind,
    int rows_in, int lanes_in, int rows_out, int lanes_out,
    const void* tvh, const void* tvl, const void* offs_v,
    int bv, int tv, int wv,
    const void* thh, const void* thl, const void* offs_l, const void* rel,
    int bh, int n_ch, int win_c, int tc,
    const void* k_range, int n_slices, const void* h_range,
    float out_max, float tm, int trunc_bits,
    int gamma, int alpha_lane, float in_gamma_mult, float out_gamma_mult,
    float scale, int even) {
  Args a;
  a.x = x;
  a.in_kind = in_kind;
  a.rows_in = rows_in;
  a.lanes_in = lanes_in;
  a.out = out;
  a.out_kind = out_kind;
  a.rows_out = rows_out;
  a.lanes_out = lanes_out;
  a.tvh = static_cast<const __nv_bfloat16*>(tvh);
  a.tvl = static_cast<const __nv_bfloat16*>(tvl);
  a.offs_v = static_cast<const int32_t*>(offs_v);
  a.tv = tv;
  a.wv = wv;
  a.thh = static_cast<const __nv_bfloat16*>(thh);
  a.thl = static_cast<const __nv_bfloat16*>(thl);
  a.offs_l = static_cast<const int32_t*>(offs_l);
  a.rel = static_cast<const int32_t*>(rel);
  a.n_ch = n_ch;
  a.win_c = win_c;
  a.tc = tc;
  a.k_range = static_cast<const int32_t*>(k_range);
  a.n_slices = n_slices;
  a.h_range = static_cast<const int32_t*>(h_range);
  a.epi.alpha_lane = alpha_lane;
  a.epi.in_gamma_mult = in_gamma_mult;
  a.epi.out_gamma_mult = out_gamma_mult;
  a.epi.scale = scale;
  a.epi.even = even;
  a.epi.trunc_bits = trunc_bits;
  a.epi.tm = tm;
  a.epi.out_max = out_max;
  const dim3 grid(bh * n_ch, bv * n_slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      gamma ? launch_modes<true>(hv, split3_v, split3_h, a, grid, s)
            : launch_modes<false>(hv, split3_v, split3_h, a, grid, s);
  return static_cast<int>(e);
}
