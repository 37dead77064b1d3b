// Lane-contracting banded pass (K3) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// avir_tpu/ops/pallas/lanes_kernel.py:41 apply_lanes_pallas -> _kernel
// (:24).  For each lane block b of a lane-blocked operator (ops/lanes.py),
// in its chunked form (one 128-lane output chunk j at a time, over the
// chunk's window lanes from offs_l[b] + rel[j]):
//
//   out[:, b*TC + 128 j + n] = sum_k x[:, offs_l[b] + rel[j] + k] * taps[b][j][k][n]
//
// with x [rows, lanes_in] interleaved (u8, u16 or f32, converted as it is
// staged; lanes past lanes_in read 0) and out f32 [rows, lanes_out] in the
// final interleaved layout (lanes past TC in a chunk or past lanes_out
// are not written).
//
// Modes (the same function as the TPU kernel, summed in another order):
//   split2  sum bf16(x) * (hi + lo)
//   split3  ... + bf16(x - f32(bf16(x))) * hi     (round to nearest even)
// Every product is bf16 x bf16, exact in float32.  The residual is computed
// with __float2bfloat16_rn and __fsub_rn, so nvcc cannot contract it.
//
// Design: the second pass of K1 split vh (fused_split.cu) alone, fed from
// the image as K2's banded_mma (banded.cu) feeds its first pass; the
// helpers come from mma_bf16.cuh and cp_async.cuh.  The bf16 tensor
// cores, mma.sync m16n8k16 (row.col, f32 accumulate) on ldmatrix
// fragments: A is the image tile [64 rows][32 window lanes] (bf16 hi and,
// in split3, residual planes, as stored), B the chunk's lane taps [32][128]
// (.trans).  A block owns 64 image rows (kRows) and one output chunk, with
// 8 warps of 16 rows x 64 lanes.  The contraction runs over the chunk's
// nonzero lane-tap rows only (h_range, 32-aligned), 32 a step, as one
// double-buffered sequence: while a step's MMAs run, the next step's taps
// (hi and lo) are in flight by cp.async and its image elements (8 lanes of
// one row a thread) in registers by vector loads where the row pitch and
// the pointer are 16-byte aligned (one 8-byte load for u8, one 16-byte
// load for u16, two for f32; scalar loads otherwise, zeros past the edge);
// after the MMAs they are converted to f32, split into bf16 hi and lo and
// stored to the other buffer, and one barrier ends the step.  The two or
// three split products of a step are consecutive MMAs into one
// accumulator; 16-lane groups past the chunk's last output lane are
// skipped.  Shared-memory rows are padded (the image tile to 40 bf16, the
// taps to 136) so the 8 rows of each ldmatrix phase fall in distinct banks.
// Pairs of lanes are stored as float2 where TC and lanes_out are even.
// 55,296 bytes of dynamic shared memory and at most 80 registers a thread
// (__launch_bounds__(256, 3); ptxas spills 8 bytes in split3 f32 only), so
// three blocks (24 warps) share an SM: at the unfused cells a block runs
// only 3-6 steps, and a third block hides more of each step's latency than
// the registers it costs (PERF.md).
//
// The dense chunk taps are channel-diagonal and banded, so the MMAs issue
// several times the band's MACs (a chunk's h_range of 128-192 window lanes
// against a band of width x C lanes); at the unfused cells that is
// microseconds at the bf16 tensor-core rate, under the bytes bound
// (chip_smoke.py prints both counts).
//
// What bounds it on this card.  The input read once and the float32
// output written once: memory-bound at the unfused main-path shapes
// (3.35 TB/s; e.g. 720 x 3840 u8 in, 720 x 5760 f32 out: 19.4 MB, 5.8 us;
// 1080 x 5760 f32 in, 1080 x 11520 f32 out: 74.6 MB, 22.4 us).  Each
// image element is staged once per chunk whose window covers it (the
// windows of neighbouring chunks overlap).
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
constexpr int kRows = 64;     // image rows per block
constexpr int kLanes = 128;   // output lanes per block (one chunk)
constexpr int kDepth = 32;    // window lanes per step
constexpr int kXLd = kDepth + 8;  // image tile row stride in shared memory (bf16)
constexpr int kTLd = kLanes + 8;  // tap row stride (bf16)
constexpr int kElems = kRows * kDepth / kThreads;  // image elements a thread stages

struct Args {
  const void* x;
  int rows, lanes_in;          // x is [rows, lanes_in]
  float* out;                  // [rows, lanes_out]
  int lanes_out;
  const __nv_bfloat16* thh;    // [Bh, n_ch, win_c, 128] chunked lane taps
  const __nv_bfloat16* thl;
  const int32_t* offs_l;       // [Bh] window start of each lane block
  const int32_t* rel;          // [n_ch] chunk offset inside the window
  const int32_t* h_range;      // [Bh, n_ch, 2] nonzero tap rows, 32-aligned
  int n_ch, win_c, tc;
};

__device__ __forceinline__ uint32_t raw_bits(uint8_t v) { return v; }
__device__ __forceinline__ uint32_t raw_bits(uint16_t v) { return v; }
__device__ __forceinline__ uint32_t raw_bits(float v) { return __float_as_uint(v); }

// Eight consecutive input elements of one row, as loaded: 2, 4 or 8
// 32-bit words (u8, u16, f32).  ``load`` reads them by vector loads when
// ``vec`` and all 8 are in range, else the first n one by one (the rest
// 0); ``get`` converts element e to f32.
template <typename T>
struct Raw8 {
  static constexpr int kWords = kElems * static_cast<int>(sizeof(T)) / 4;
  static constexpr int kPer = 4 / static_cast<int>(sizeof(T));  // elements a word
  uint32_t w[kWords];

  __device__ void load(const T* p, int n, bool vec) {
    if (vec && n == kElems) {
      if constexpr (kWords == 2) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        w[0] = v.x;
        w[1] = v.y;
      } else {
#pragma unroll
        for (int i = 0; i < kWords / 4; ++i) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
          w[4 * i] = v.x;
          w[4 * i + 1] = v.y;
          w[4 * i + 2] = v.z;
          w[4 * i + 3] = v.w;
        }
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
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

// Shared memory, in bf16 elements:
//   sx [2 buf][2 plane][kRows][kXLd]     image tile hi / residual
//   st [2 buf][2 plane][kDepth][kTLd]    lane taps hi / lo
struct Smem {
  static constexpr int kSx = 2 * 2 * kRows * kXLd;
  static constexpr int kSt = 2 * 2 * kDepth * kTLd;
  static constexpr size_t kBytes = static_cast<size_t>(kSx + kSt) * 2;
  __device__ static int sx(int b, int p, int r, int k) {
    return ((b * 2 + p) * kRows + r) * kXLd + k;
  }
  __device__ static int st(int b, int p, int k, int n) {
    return kSx + ((b * 2 + p) * kDepth + k) * kTLd + n;
  }
};

template <bool S3, typename TIn>
struct Lanes {
  using S = Smem;

  // Tap rows k0..k0+31 of chunk ``chunk`` (hi and lo) into buffer buf.
  __device__ static void stage_taps(const Args& a, uint16_t* sm, int buf, int chunk, int k0) {
    const size_t base = (static_cast<size_t>(chunk) * a.win_c + k0) * kLanes;
    for (int c = threadIdx.x; c < 2 * kDepth * (kLanes / 8); c += kThreads) {
      const int p = c / (kDepth * (kLanes / 8)), k = (c / (kLanes / 8)) % kDepth;
      const int part = c % (kLanes / 8);
      cp16(sm + S::st(buf, p, k, part * 8), (p ? a.thl : a.thh) + base + k * kLanes + part * 8,
           true);
    }
  }

  // This thread's 8 image elements of the step at window lane ``lane0``:
  // row r0 + thread / 4, lanes lane0 + 8 (thread % 4) .., zero past the edge.
  __device__ static void load_x(const Args& a, int r0, int lane0, bool vec, Raw8<TIn>& raw) {
    const int r = r0 + threadIdx.x / 4, l = lane0 + kElems * (threadIdx.x % 4);
    const int n = r < a.rows ? max(0, min(kElems, a.lanes_in - l)) : 0;
    const TIn* p =
        static_cast<const TIn*>(a.x) + (n > 0 ? static_cast<size_t>(r) * a.lanes_in + l : 0);
    raw.load(p, n, vec);
  }

  // The registers of load_x converted and split into buffer buf.
  __device__ static void store_x(uint16_t* sm, int buf, const Raw8<TIn>& raw) {
    const int r = threadIdx.x / 4, k = kElems * (threadIdx.x % 4);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_pair(raw.get(2 * i), raw.get(2 * i + 1), hi[i], lo[i]);
    *reinterpret_cast<uint4*>(sm + S::sx(buf, 0, r, k)) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    if (S3) {
      *reinterpret_cast<uint4*>(sm + S::sx(buf, 1, r, k)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
};

// One block: image rows r0..r0+63 x output chunk ``chunk`` (lane block b,
// chunk jc).  Warp (wm, wn) owns rows 16 wm..16 wm + 15 and chunk lanes
// 64 wn..64 wn + 63.
template <bool S3, typename TIn>
__global__ void __launch_bounds__(kThreads, 3) lanes_mma(const Args a) {
  using K = Lanes<S3, TIn>;
  using S = Smem;
  constexpr int kWn = 2;               // warps across lanes
  constexpr int kWc = kLanes / kWn;    // lanes a warp
  constexpr int kNt = kWc / 8;         // n8 tiles a warp
  extern __shared__ __align__(16) uint16_t sm[];

  const int chunk = blockIdx.x;
  const int b = chunk / a.n_ch, jc = chunk % a.n_ch;
  const int r0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int wm = warp / kWn, wn = warp % kWn;
  const int arow = lid & 15, acol = (lid >> 4) * 8;  // ldmatrix address of this thread
  const int g = lid / 4, t = lid % 4;                // accumulator row / lane pair
  const int k_lo = a.h_range[2 * chunk], k_hi = a.h_range[2 * chunk + 1];
  const int lane0 = a.offs_l[b] + a.rel[jc] + k_lo;  // image lane of the first step
  const int nv = (k_hi - k_lo) / kDepth;
  const int col0 = b * a.tc + jc * kLanes;           // output lane of chunk lane 0
  const int lim = min(a.tc - jc * kLanes, a.lanes_out - col0);  // chunk lanes written
  // Window starts are multiples of 128 lanes and h_range of 32, so every
  // thread's 8 lanes start 8-aligned; vector loads need the rows aligned too.
  const bool vec = (reinterpret_cast<uintptr_t>(a.x) & 15) == 0 &&
                   (a.lanes_in * static_cast<int>(sizeof(TIn))) % 16 == 0 && lane0 % kElems == 0;

  float acc[kNt][4] = {};
  // No nonzero tap: the block's sums are 0.
  if (nv > 0) {
    Raw8<TIn> raw;
    K::stage_taps(a, sm, 0, chunk, k_lo);
    cp_commit();
    K::load_x(a, r0, lane0, vec, raw);
    K::store_x(sm, 0, raw);
    cp_wait_all();
    __syncthreads();
    for (int i = 0; i < nv; ++i) {
      const int buf = i & 1;
      const bool more = i + 1 < nv;
      if (more) {
        K::stage_taps(a, sm, buf ^ 1, chunk, k_lo + (i + 1) * kDepth);
        cp_commit();
        K::load_x(a, r0, lane0 + (i + 1) * kDepth, vec, raw);
      }
#pragma unroll
      for (int k16 = 0; k16 < kDepth; k16 += 16) {
        uint32_t xh[4], xl[4];
        ldsm(xh, sm + S::sx(buf, 0, 16 * wm + arow, k16 + acol));
        if (S3) ldsm(xl, sm + S::sx(buf, 1, 16 * wm + arow, k16 + acol));
#pragma unroll
        for (int q = 0; q < kNt / 2; ++q) {
          const int n0 = kWc * wn + 16 * q;
          if (n0 >= lim) continue;  // lanes past the chunk's last output
          uint32_t th[4], tl[4];
          ldsm_t(th, sm + S::st(buf, 0, k16 + arow, n0 + acol));
          ldsm_t(tl, sm + S::st(buf, 1, k16 + arow, n0 + acol));
          mma(acc[2 * q], xh, th[0], th[1]);
          mma(acc[2 * q + 1], xh, th[2], th[3]);
          mma(acc[2 * q], xh, tl[0], tl[1]);
          mma(acc[2 * q + 1], xh, tl[2], tl[3]);
          if (S3) {
            mma(acc[2 * q], xl, th[0], th[1]);
            mma(acc[2 * q + 1], xl, th[2], th[3]);
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

  // ---- store: accumulator (row g (+8), lanes 2t, 2t+1 of tile n) --------
  const bool pairs = a.tc % 2 == 0 && a.lanes_out % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * wm + g + 8 * h;
    if (row >= a.rows) continue;
    float* o = a.out + static_cast<size_t>(row) * a.lanes_out + col0;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      const int cl = kWc * wn + 8 * n + 2 * t;
      if (pairs && cl + 1 < lim) {
        *reinterpret_cast<float2*>(o + cl) = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
      } else {
        if (cl < lim) o[cl] = acc[n][2 * h];
        if (cl + 1 < lim) o[cl + 1] = acc[n][2 * h + 1];
      }
    }
  }
}

template <bool S3, typename TIn>
cudaError_t launch_mma(const Args& a, dim3 grid, cudaStream_t s) {
  constexpr size_t bytes = Smem::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      lanes_mma<S3, TIn>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  lanes_mma<S3, TIn><<<grid, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <bool S3>
cudaError_t launch(const Args& a, int in_kind, dim3 grid, cudaStream_t s) {
  if (in_kind == 0) return launch_mma<S3, uint8_t>(a, grid, s);
  if (in_kind == 1) return launch_mma<S3, uint16_t>(a, grid, s);
  return launch_mma<S3, float>(a, grid, s);
}

}  // namespace

extern "C" int avir_lanes(
    const void* x, void* out, int in_kind, int rows, void* stream,
    int split3, int lanes_in, int lanes_out,
    const void* thh, const void* thl, const void* offs_l, const void* rel,
    const void* h_range,
    int bh, int n_ch, int win_c, int tc) {
  Args a;
  a.x = x;
  a.rows = rows;
  a.lanes_in = lanes_in;
  a.out = static_cast<float*>(out);
  a.lanes_out = lanes_out;
  a.thh = static_cast<const __nv_bfloat16*>(thh);
  a.thl = static_cast<const __nv_bfloat16*>(thl);
  a.offs_l = static_cast<const int32_t*>(offs_l);
  a.rel = static_cast<const int32_t*>(rel);
  a.h_range = static_cast<const int32_t*>(h_range);
  a.n_ch = n_ch;
  a.win_c = win_c;
  a.tc = tc;
  const dim3 grid(bh * n_ch, (rows + kRows - 1) / kRows);
  if (win_c % kDepth != 0 || tc > n_ch * kLanes || grid.y > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || grid.x == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(split3 ? launch<true>(a, in_kind, grid, s)
                                 : launch<false>(a, in_kind, grid, s));
}
