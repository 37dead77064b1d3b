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
// Modes (the same function as the TPU kernel, summed in another order):
//   split2  sum hi*bf16(x) + lo*bf16(x)
//   split3  ... + hi*bf16(x - f32(bf16(x)))      (round to nearest even)
//   exact   sum f32(hi + lo) * x in float32 (hi + lo is exact in f32)
// Every split product is bf16 x bf16, exact in float32.  The residual is
// computed with __float2bfloat16_rn and __fsub_rn, so nvcc cannot contract
// it.
//
// Split modes (banded_mma): the bf16 tensor cores, mma.sync m16n8k16
// (row.col, f32 accumulate) on fragments that ldmatrix reads from shared
// memory (.trans for the input tile, which is [K][N]), as K1 split vh's
// first pass (fused_split.cu; the helpers in mma_bf16.cuh and
// cp_async.cuh).  A block owns 64 output rows (kRows, a slice of one row
// block) and 128 columns, with 8 warps of 16 rows x 64 columns.  The
// contraction runs over the slice's nonzero tap rows only (k_range at
// 64-row slices, 32-aligned), 32 a step, as one double-buffered sequence:
// while a step's MMAs run, the next step's taps ([64][32] bf16 hi and
// lo) are in flight by cp.async and its input rows (16 columns of one row
// a thread) in registers by 16-byte vector loads where the row width and
// the pointer allow (scalar loads at the edge, zeros past it); after the MMAs
// they are converted to f32, split into bf16 hi and lo and stored to the
// other buffer, and one barrier ends the step.  The two or three split
// products of a step are consecutive MMAs into one accumulator.  Rows of
// shared memory are padded (taps to 40 bf16, the input tile to 136) so the
// 8 rows of each ldmatrix phase fall in distinct banks; tap rows start
// 16-byte aligned (W is a multiple of 128 taps, k_range of 32).  Rows past
// T or n_out and columns past the row width are not written; pairs of
// columns are stored as float2 where the width is even.
//
// exact (banded_exact, reached by no resize): full float32 has no tensor
// core, so it keeps the first port's design: 32 output rows x 128 columns
// a block, 256 threads each 4 rows x 4 columns with fmaf over the slice's
// nonzero tap rows (k_range at 32-row slices), 32 a step, in 32 KB of
// static shared memory.
//
// What bounds it on this card.  The input read once and the float32
// output written once: memory-bound at the unfused main-path shapes (3.35
// TB/s; 1280x720 -> 1920x1080 RGB, f32 [720, 5760] in and [1080, 5760]
// out: 41.5 MB, 12.4 us; 1920x1080 -> 3840x2160: 149 MB, 44.6 us), while
// the MMAs over the dense tap blocks are microseconds at the bf16
// tensor-core rate.  The design reads each input row once per slice whose
// range covers it (about twice at 2x upsizes).  Measured on an H100 80GB
// HBM3 at 700 W (chip_smoke.py --kernel-times, PERF.md), split3 on K3's
// f32 output: 0.034-0.036 ms at 720p -> 1080p (2.8x the bound) and
// 0.104-0.105 ms at 1080p -> 4K (2.3x), against 0.153-0.187 and
// 0.519-0.531 for the fmaf design it replaces (2-3 fmaf a MAC on the CUDA
// cores, scalar loads, two barriers a step) and 0.22 / 1.10 for one
// float32 torch.matmul with the dense operator.  64-row slices ran 7-9%
// faster than 32-row ones at both shapes, so the height is fixed at 64.
//
// Tolerance: tensor-core sums of exact products are f32 in the hardware's
// order and rounding: within max|plain| * 1e-5 of the plain version.

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
constexpr int kRows = 64;   // output rows per block of the split modes
constexpr int kExactRows = 32;  // ... of exact

enum Mode { kSplit2 = 0, kSplit3 = 1, kExact = 2 };

struct Args {
  const void* x;
  int in_kind;               // 0 u8, 1 u16, 2 f32
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

// ---------------------------------------------------------------------------
// Split modes on the bf16 tensor cores
// ---------------------------------------------------------------------------

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

// Shared memory of banded_mma, in bf16 elements:
//   sv [2 buf][2 plane][kRows][kTapLd]    taps hi / lo
//   sx [2 buf][2 plane][32][kTileLd]      input tile hi / residual
struct MmaSmem {
  static constexpr int kSv = 2 * 2 * kRows * kTapLd;
  static constexpr int kSx = 2 * 2 * kDepth * kTileLd;
  static constexpr size_t kBytes = static_cast<size_t>(kSv + kSx) * 2;
  __device__ static int sv(int b, int p, int r, int k) {
    return ((b * 2 + p) * kRows + r) * kTapLd + k;
  }
  __device__ static int sx(int b, int p, int r, int c) {
    return kSv + ((b * 2 + p) * kDepth + r) * kTileLd + c;
  }
};

template <bool S3, typename TIn>
struct Banded {
  using S = MmaSmem;

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

  // The registers of load_x converted and split into buffer buf.
  __device__ static void store_x(uint16_t* sm, int buf, const Raw16<TIn>& raw) {
    const int k = threadIdx.x / 8, c = 16 * (threadIdx.x % 8);
    uint32_t hi[8], lo[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) split_pair(raw.get(2 * i), raw.get(2 * i + 1), hi[i], lo[i]);
    uint4* dh = reinterpret_cast<uint4*>(sm + S::sx(buf, 0, k, c));
    dh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    dh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    if (S3) {
      uint4* dl = reinterpret_cast<uint4*>(sm + S::sx(buf, 1, k, c));
      dl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    }
  }
};

// One block: output rows r0..r0+kRows-1 of row block b (slice ``slice``) x
// columns c0..c0+127.  Warp (wm, wn) owns rows 16 wm..16 wm + 15 and
// columns kWc wn..kWc wn + kWc - 1.
template <bool S3, typename TIn>
__global__ void __launch_bounds__(kThreads, 2) banded_mma(const Args a) {
  using K = Banded<S3, TIn>;
  using S = MmaSmem;
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
          uint32_t xh[4];
          ldsm_t(xh, sm + S::sx(buf, 0, k16 + arow, n0 + acol));
          mma(acc[2 * q], th, xh[0], xh[1]);
          mma(acc[2 * q + 1], th, xh[2], xh[3]);
          mma(acc[2 * q], tl, xh[0], xh[1]);
          mma(acc[2 * q + 1], tl, xh[2], xh[3]);
          if (S3) {
            uint32_t xl[4];
            ldsm_t(xl, sm + S::sx(buf, 1, k16 + arow, n0 + acol));
            mma(acc[2 * q], th, xl[0], xl[1]);
            mma(acc[2 * q + 1], th, xl[2], xl[3]);
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

template <bool S3, typename TIn>
cudaError_t launch_mma(const Args& a, dim3 grid, cudaStream_t s) {
  constexpr size_t bytes = MmaSmem::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      banded_mma<S3, TIn>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  banded_mma<S3, TIn><<<grid, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <bool S3>
cudaError_t launch_split(const Args& a, dim3 grid, cudaStream_t s) {
  if (a.in_kind == 0) return launch_mma<S3, uint8_t>(a, grid, s);
  if (a.in_kind == 1) return launch_mma<S3, uint16_t>(a, grid, s);
  return launch_mma<S3, float>(a, grid, s);
}

// ---------------------------------------------------------------------------
// exact: float32 fmaf on the CUDA cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float load_x(const Args& a, int row, int col) {
  if (row >= a.n_in || col >= a.r) return 0.0f;
  const size_t i = static_cast<size_t>(row) * a.r + col;
  if (a.in_kind == 0) return static_cast<float>(__ldg(static_cast<const uint8_t*>(a.x) + i));
  if (a.in_kind == 1) return static_cast<float>(__ldg(static_cast<const uint16_t*>(a.x) + i));
  return __ldg(static_cast<const float*>(a.x) + i);
}

__global__ void __launch_bounds__(kThreads) banded_exact(const Args a) {
  __shared__ float st[kExactRows][kDepth];             // taps hi + lo
  __shared__ __align__(16) float sx[kDepth][kCols];    // input

  const int b = blockIdx.y / a.n_slices, sl = blockIdx.y % a.n_slices;
  const int r0 = sl * kExactRows;
  const int c0 = blockIdx.x * kCols;
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
  const int k_lo = a.k_range[2 * blockIdx.y];
  const int k_hi = a.k_range[2 * blockIdx.y + 1];
  const int row0 = a.offs[b];

  float acc[4][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += kDepth) {
    __syncthreads();
    for (int e = tid; e < kExactRows * kDepth; e += kThreads) {
      const int tr = r0 + e / kDepth, k = e % kDepth;
      float h = 0.0f, l = 0.0f;
      if (tr < a.t) {
        const size_t off = (static_cast<size_t>(b) * a.t + tr) * a.w + k0 + k;
        h = __bfloat162float(a.hi[off]);
        l = __bfloat162float(a.lo[off]);
      }
      st[e / kDepth][k] = __fadd_rn(h, l);
    }
    for (int e = tid; e < kDepth * kCols; e += kThreads) {
      const int k = e / kCols, col = e % kCols;
      sx[k][col] = load_x(a, row0 + k0 + k, c0 + col);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kDepth; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(&sx[k][4 * tx]);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float th = st[4 * ty + i][k];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(th, xs[jj], acc[i][jj]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tr = r0 + 4 * ty + i;
    const int orow = b * a.t + tr;
    if (tr >= a.t || orow >= a.n_out) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = c0 + 4 * tx + jj;
      if (col < a.r) a.out[static_cast<size_t>(orow) * a.r + col] = acc[i][jj];
    }
  }
}

}  // namespace

// k_range holds the slices of the mode's height: kRows (64) rows in the
// split modes, kExactRows (32) in exact (banded_kernel.py).
extern "C" int avir_banded(
    int mode, int in_kind,
    const void* x, int n_in, int r,
    void* out, int n_out,
    const void* hi, const void* lo, const void* offs,
    int b, int t, int w,
    const void* k_range, int n_slices,
    void* stream) {
  Args a;
  a.x = x;
  a.in_kind = in_kind;
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
  const int rows = mode == kExact ? kExactRows : kRows;
  if (n_slices != (t + rows - 1) / rows || w % kCols != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((r + kCols - 1) / kCols, b * n_slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kExact) {
    banded_exact<<<grid, kThreads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(mode == kSplit3 ? launch_split<true>(a, grid, s)
                                          : launch_split<false>(a, grid, s));
}
