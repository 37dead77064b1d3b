// Row-contracting banded pass (K2) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// avir_tpu/ops/pallas/banded_kernel.py:58 apply_blocked_pallas -> _kernel
// (:37).  For each row block b of a blocked banded operator (ops/banded.py):
//
//   out[b*T + t, :] = sum_w taps[b][t][w] * x[offs[b] + w, :]
//
// x is [n_in, R] (u8, u16 or f32, converted as it is staged; rows past
// n_in read 0), out is f32 [n_out, R] (rows past n_out are not written).
//
// Every mode sums bf16 x bf16 products, each exact in float32, of the
// taps' bf16 hi/lo pair and the input's bf16 limbs x0 = bf16(x), x1 =
// bf16(x - x0), x2 = bf16(x - x0 - x1) (round to nearest even; the
// subtractions by __fsub_rn, so nvcc cannot contract them):
//   split2  hi*x0 + lo*x0
//   split3  ... + hi*x1
//   exact   (hi + lo) * (x0 + x1 + x2), the TPU kernel's f32(hi + lo) * x
//           at Precision.HIGHEST.  The limbs sum back to x exactly: u8
//           needs x0 alone (exact then issues split2's products, and runs
//           split2's kernel), u16 x0 and x1, f32 all three (in bf16's
//           normal range: below about 2^-110 x2 loses bits; image data
//           never goes there).  Every product is exact, so exact differs
//           from an fmaf loop only in the order of the float32 additions.
//
// One kernel runs every mode, banded_mma<NX, EXACT, TIn> (NX input limb
// planes; EXACT: the tap lo plane multiplies every limb, not x0 alone), on
// the bf16 tensor cores: mma.sync m16n8k16 (row.col, f32 accumulate) on
// fragments that ldmatrix reads from shared memory (.trans for the input
// tile, which is [K][N]), as K1 split vh's first pass (fused_split.cu; the
// helpers in mma_bf16.cuh and cp_async.cuh).  A block owns 64 output rows
// (kRows, a slice of one row block) and 128 columns, with 8 warps of 16
// rows x 64 columns.  The contraction runs over the slice's nonzero tap
// rows only (k_range at 64-row slices, 32-aligned), 32 a step, as one
// double-buffered sequence: while a step's MMAs run, the next step's taps
// ([64][32] bf16 hi and lo) are in flight by cp.async and its input rows
// (16 columns of one row a thread) in registers by 16-byte vector loads
// where the row width and the pointer allow (scalar loads at the edge,
// zeros past it, so every limb is 0 there); after the MMAs they are
// converted to f32, split into NX limbs and stored to the other buffer,
// and one barrier ends the step.  A step's products are consecutive MMAs
// into one accumulator: 2 for each MMA tile in split2 (and exact on u8), 3
// in split3, 4 in exact on u16, 6 in exact on f32.  Rows of shared memory
// are padded (taps to 40 bf16, the input tile to 136) so the 8 rows of
// each ldmatrix phase fall in distinct banks; tap rows start 16-byte
// aligned (W is a multiple of 128 taps, k_range of 32).  Shared memory:
// 20,480 bytes of taps and 17,408 a limb plane (two buffers), 37.9 KB (NX
// = 1) to 72.7 KB (NX = 3), so two blocks fit an SM in every mode, at 96 to
// 128 registers a thread and no spills.  Rows past T or n_out and columns
// past the row width are not written; pairs of columns are stored as
// float2 where the width is even.
//
// What bounds it on this card.  The input read once and the float32
// output written once: memory-bound at the unfused main-path shapes (3.35
// TB/s; 1280x720 -> 1920x1080 RGB, f32 [720, 5760] in and [1080, 5760]
// out: 41.5 MB, 12.4 us; 1920x1080 -> 3840x2160: 149 MB, 44.6 us), while
// the MMAs over the dense tap blocks are microseconds at the bf16
// tensor-core rate, exact's six products included (exact's own work, 2 x
// band MACs at the 67 TFLOP/s of float32 outside the tensor cores, is 13.4
// us at 1080p -> 4K).  The design reads each input row once per slice
// whose range covers it (about twice at 2x upsizes).  Measured on an H100
// 80GB HBM3 at 700 W (chip_smoke.py --kernel-times, PERF.md), on K3's f32
// output: split3 0.033-0.036 ms at 720p -> 1080p (2.7x the bound) and
// 0.104-0.110 ms at 1080p -> 4K (2.3x), exact 0.037-0.038 and 0.121 (the
// fmaf kernels these replaced: 0.153-0.187 and 0.519-0.531 for split3,
// 0.087-0.090 and 0.294-0.296 for exact); exact on the 720p u8 image
// 0.020 ms (split2's kernel, bit-equal to it) and on it as u16 0.023.
// 64-row slices ran 7-9% faster than 32-row ones at both shapes in split3,
// so the height is fixed at 64.
//
// Tolerance: tensor-core sums of exact products are f32 in the hardware's
// order and rounding: within max|plain| * 1e-5 of the plain version, in
// every mode.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace cp_async;
using namespace mma_bf16;

constexpr int kThreads = 256;
constexpr int kCols = 128;  // columns per block
constexpr int kDepth = 32;  // contraction rows staged per step
constexpr int kRows = 64;   // output rows per block

enum Mode { kSplit2 = 0, kSplit3 = 1, kExact = 2 };

struct Args {
  const void* x;
  int n_in, r;               // x is [n_in, r]
  float* out;                // [n_out, r]
  int n_out;
  const __nv_bfloat16* hi;   // [B, T, W]
  const __nv_bfloat16* lo;
  const int32_t* offs;       // [B]
  int t, w;
  const int32_t* k_range;    // [B, n_slices, 2] nonzero tap rows of each slice, 32-aligned
  int n_slices;
};

constexpr int kTapLd = kDepth + 8;  // tap row stride in shared memory (bf16)
constexpr int kTileLd = kCols + 8;  // input tile row stride (bf16)

__device__ __forceinline__ uint32_t raw_bits(uint8_t v) { return v; }
__device__ __forceinline__ uint32_t raw_bits(uint16_t v) { return v; }
__device__ __forceinline__ uint32_t raw_bits(float v) { return __float_as_uint(v); }

// Sixteen consecutive input elements of one row, as loaded: 4, 8 or 16
// 32-bit words (u8, u16, f32).  ``load`` reads them by 16-byte vector loads
// when ``vec`` and all 16 are in range, else the first n one by one (the
// rest 0); ``get`` converts element e to f32.
template <typename T>
struct Raw16 {
  static constexpr int kWords = 4 * static_cast<int>(sizeof(T));
  static constexpr int kPer = 4 / static_cast<int>(sizeof(T));  // elements a word
  uint32_t w[kWords];

  __device__ void load(const T* p, int n, bool vec) {
    if (vec && n == 16) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      if (e < n) w[e / kPer] |= raw_bits(__ldg(p + e)) << (32 / kPer * (e % kPer));
    }
  }

  __device__ float get(int e) const {
    const uint32_t v = w[e / kPer];
    if (sizeof(T) == 4) return __uint_as_float(v);
    const int sh = 32 / kPer * (e % kPer);
    return static_cast<float>((v >> sh) & (sizeof(T) == 1 ? 0xffu : 0xffffu));
  }
};

// Shared memory of banded_mma with NX input limb planes, in bf16 elements:
//   sv [2 buf][2 plane][kRows][kTapLd]    taps hi / lo
//   sx [2 buf][NX plane][32][kTileLd]     input limbs x0, x1, x2
template <int NX>
struct MmaSmem {
  static constexpr int kSv = 2 * 2 * kRows * kTapLd;
  static constexpr int kSx = 2 * NX * kDepth * kTileLd;
  static constexpr size_t kBytes = static_cast<size_t>(kSv + kSx) * 2;
  __device__ static int sv(int b, int p, int r, int k) {
    return ((b * 2 + p) * kRows + r) * kTapLd + k;
  }
  __device__ static int sx(int b, int p, int r, int c) {
    return kSv + ((b * NX + p) * kDepth + r) * kTileLd + c;
  }
};

template <int NX, typename TIn>
struct Banded {
  using S = MmaSmem<NX>;

  // Taps of rows r0..r0+kRows-1 of row block b over k0..k0+31 into buffer buf
  // (rows past T: zeros).
  __device__ static void stage_taps(const Args& a, uint16_t* sm, int buf, int b, int r0, int k0) {
    for (int c = threadIdx.x; c < 2 * kRows * 4; c += kThreads) {
      const int p = c / (kRows * 4), r = (c / 4) % kRows, part = c % 4;
      const bool valid = r0 + r < a.t;
      const size_t row = static_cast<size_t>(b) * a.t + (valid ? r0 + r : 0);
      cp16(sm + S::sv(buf, p, r, part * 8), (p ? a.lo : a.hi) + row * a.w + k0 + part * 8, valid);
    }
  }

  // This thread's 16 input elements of step row ``row`` (input row
  // row0 + thread / 8, columns c0 + 16 (thread % 8) ..), zero past the edge.
  __device__ static void load_x(const Args& a, int row, int c0, bool vec, Raw16<TIn>& raw) {
    const int r = row + threadIdx.x / 8, c = c0 + 16 * (threadIdx.x % 8);
    const int n = r < a.n_in ? max(0, min(16, a.r - c)) : 0;
    const TIn* p = static_cast<const TIn*>(a.x) + (n > 0 ? static_cast<size_t>(r) * a.r + c : 0);
    raw.load(p, n, vec);
  }

  // The registers of load_x converted and split into NX bf16 limbs in
  // buffer buf: limb p is bf16 of what limbs 0..p-1 left of the value,
  // each plane stored as soon as it is split.
  __device__ static void store_x(uint16_t* sm, int buf, const Raw16<TIn>& raw) {
    const int k = threadIdx.x / 8, c = 16 * (threadIdx.x % 8);
    float v[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = raw.get(e);
#pragma unroll
    for (int p = 0; p < NX; ++p) {
      uint32_t limb[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        limb[i] = bits(h);
        if (p + 1 < NX) {
          const float2 hf = __bfloat1622float2(h);
          v[2 * i] = __fsub_rn(v[2 * i], hf.x);
          v[2 * i + 1] = __fsub_rn(v[2 * i + 1], hf.y);
        }
      }
      uint4* d = reinterpret_cast<uint4*>(sm + S::sx(buf, p, k, c));
      d[0] = make_uint4(limb[0], limb[1], limb[2], limb[3]);
      d[1] = make_uint4(limb[4], limb[5], limb[6], limb[7]);
    }
  }
};

// One block: output rows r0..r0+kRows-1 of row block b (slice ``slice``) x
// columns c0..c0+127.  Warp (wm, wn) owns rows 16 wm..16 wm + 15 and
// columns kWc wn..kWc wn + kWc - 1.  A step's products go into one
// accumulator in the order hi*x0, lo*x0, hi*x1 (split2 stops after lo*x0,
// split3 there), lo*x1, hi*x2, lo*x2.
template <int NX, bool EXACT, typename TIn>
__global__ void __launch_bounds__(kThreads, 2) banded_mma(const Args a) {
  using K = Banded<NX, TIn>;
  using S = MmaSmem<NX>;
  constexpr int kWm = kRows / 16;       // warps across rows
  constexpr int kWn = 8 / kWm;          // warps across columns
  constexpr int kWc = kCols / kWn;      // columns a warp
  constexpr int kNt = kWc / 8;          // n8 tiles a warp
  extern __shared__ __align__(16) uint16_t sm[];

  const int b = blockIdx.y / a.n_slices, slice = blockIdx.y % a.n_slices;
  const int r0 = slice * kRows, c0 = blockIdx.x * kCols;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int wm = warp / kWn, wn = warp % kWn;
  const int arow = lid & 15, acol = (lid >> 4) * 8;  // ldmatrix address of this thread
  const int g = lid / 4, t = lid % 4;                // accumulator row / column pair
  const int k_lo = a.k_range[2 * blockIdx.y];
  const int k_hi = a.k_range[2 * blockIdx.y + 1];
  const int row0 = a.offs[b] + k_lo;
  const int nv = (k_hi - k_lo) / kDepth;
  const bool vec = (reinterpret_cast<uintptr_t>(a.x) & 15) == 0 &&
                   (a.r * static_cast<int>(sizeof(TIn))) % 16 == 0;

  float acc[kNt][4] = {};
  // No nonzero tap: the block's sums are 0.
  if (nv > 0) {
    Raw16<TIn> raw;
    K::stage_taps(a, sm, 0, b, r0, k_lo);
    cp_commit();
    K::load_x(a, row0, c0, vec, raw);
    K::store_x(sm, 0, raw);
    cp_wait_all();
    __syncthreads();
    for (int i = 0; i < nv; ++i) {
      const int buf = i & 1;
      const bool more = i + 1 < nv;
      if (more) {
        K::stage_taps(a, sm, buf ^ 1, b, r0, k_lo + (i + 1) * kDepth);
        cp_commit();
        K::load_x(a, row0 + (i + 1) * kDepth, c0, vec, raw);
      }
#pragma unroll
      for (int k16 = 0; k16 < kDepth; k16 += 16) {
        uint32_t th[4], tl[4];
        ldsm(th, sm + S::sv(buf, 0, 16 * wm + arow, k16 + acol));
        ldsm(tl, sm + S::sv(buf, 1, 16 * wm + arow, k16 + acol));
#pragma unroll
        for (int q = 0; q < kNt / 2; ++q) {
          const int n0 = kWc * wn + 16 * q;
          if (c0 + n0 >= a.r) continue;  // columns past the image
#pragma unroll
          for (int p = 0; p < NX; ++p) {
            uint32_t xb[4];
            ldsm_t(xb, sm + S::sx(buf, p, k16 + arow, n0 + acol));
            mma(acc[2 * q], th, xb[0], xb[1]);
            mma(acc[2 * q + 1], th, xb[2], xb[3]);
            if (EXACT || p == 0) {
              mma(acc[2 * q], tl, xb[0], xb[1]);
              mma(acc[2 * q + 1], tl, xb[2], xb[3]);
            }
          }
        }
      }
      if (more) {
        K::store_x(sm, buf ^ 1, raw);
        cp_wait_all();
      }
      __syncthreads();
    }
  }

  // ---- store: accumulator (row g (+8), columns 2t, 2t+1 of tile n) ------
  const bool pairs = a.r % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tr = r0 + 16 * wm + g + 8 * h;
    const int orow = b * a.t + tr;
    if (tr >= a.t || orow >= a.n_out) continue;
    float* o = a.out + static_cast<size_t>(orow) * a.r;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      const int col = c0 + kWc * wn + 8 * n + 2 * t;
      if (pairs && col + 1 < a.r) {
        *reinterpret_cast<float2*>(o + col) = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      } else {
        if (col < a.r) o[col] = acc[n][2 * h];
        if (col + 1 < a.r) o[col + 1] = acc[n][2 * h + 1];
      }
    }
  }
}

template <int NX, bool EXACT, typename TIn>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t s) {
  constexpr size_t bytes = MmaSmem<NX>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(banded_mma<NX, EXACT, TIn>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  banded_mma<NX, EXACT, TIn><<<grid, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <int NX>
cudaError_t launch_split(int in_kind, const Args& a, dim3 grid, cudaStream_t s) {
  if (in_kind == 0) return launch<NX, false, uint8_t>(a, grid, s);
  if (in_kind == 1) return launch<NX, false, uint16_t>(a, grid, s);
  return launch<NX, false, float>(a, grid, s);
}

}  // namespace

// k_range holds the nonzero tap rows of kRows-row (64) slices
// (banded_kernel.py).  in_kind: 0 u8, 1 u16, 2 f32.
extern "C" int avir_banded(
    const void* x, void* out, int in_kind, int r, void* stream,
    int mode, int n_in, int n_out,
    const void* hi, const void* lo, const void* offs,
    int b, int t, int w,
    const void* k_range, int n_slices) {
  Args a;
  a.x = x;
  a.n_in = n_in;
  a.r = r;
  a.out = static_cast<float*>(out);
  a.n_out = n_out;
  a.hi = static_cast<const __nv_bfloat16*>(hi);
  a.lo = static_cast<const __nv_bfloat16*>(lo);
  a.offs = static_cast<const int32_t*>(offs);
  a.t = t;
  a.w = w;
  a.k_range = static_cast<const int32_t*>(k_range);
  a.n_slices = n_slices;
  if (n_slices != (t + kRows - 1) / kRows || w % kCols != 0 || mode < kSplit2 ||
      mode > kExact || in_kind < 0 || in_kind > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((r + kCols - 1) / kCols, b * n_slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mode == kSplit3) {
    e = launch_split<2>(in_kind, a, grid, s);
  } else if (mode == kSplit2 || in_kind == 0) {
    // exact on u8: x0 is x, so its products are split2's.
    e = launch_split<1>(in_kind, a, grid, s);
  } else if (in_kind == 1) {
    e = launch<2, true, uint16_t>(a, grid, s);
  } else {
    e = launch<3, true, float>(a, grid, s);
  }
  return static_cast<int>(e);
}
