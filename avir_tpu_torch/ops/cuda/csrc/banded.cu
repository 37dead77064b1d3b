// Row-contracting banded pass (K2) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// avir_tpu/ops/pallas/banded_kernel.py: apply_blocked_pallas -> _kernel.
// For each row block b of a blocked banded operator (ops/banded.py):
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
// Every split product is bf16 x bf16, exact in float32; fmaf of such
// operands adds an exact product.  The residual is computed with
// __float2bfloat16_rn and __fsub_rn, so nvcc cannot contract it.
//
// Design.  A thread block owns 32 output rows (a slice of one row block)
// and 128 columns; 256 threads each own 4 rows x 4 columns and accumulate
// with fmaf on the CUDA cores.  The contraction runs over the slice's
// nonzero tap rows only (k_range, 32-aligned), 32 rows at a time: the
// taps [32][32] and the input tile [32][128] (split into hi/lo as it is
// staged) sit in 32 KB of static shared memory.
//
// What bounds it on this card.  The input read once and the float32
// output written once: memory-bound at the unfused main-path shapes
// (3.35 TB/s; e.g. 1080 x 11520 f32 in, 2160 x 11520 f32 out: 149 MB,
// 45 us), while its band MACs (2-3 bf16 products each) are microseconds
// at the tensor cores' rate.  This first version issues 2-3 fmaf per MAC
// on the CUDA cores over the 32-aligned tap range, so it is bound by
// fmaf issue and shared-memory reads; mma/wgmma on the bf16 splits are
// the planned way down.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;   // output rows per block
constexpr int kCols = 128;  // columns per block
constexpr int kDepth = 32;  // contraction rows staged per step

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
  const int32_t* k_range;    // [B, n_slices, 2] nonzero tap rows, 32-aligned
  int n_slices;
};

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_x(const Args& a, int row, int col) {
  if (row >= a.n_in || col >= a.r) return 0.0f;
  const size_t i = static_cast<size_t>(row) * a.r + col;
  if (a.in_kind == 0) return static_cast<float>(__ldg(static_cast<const uint8_t*>(a.x) + i));
  if (a.in_kind == 1) return static_cast<float>(__ldg(static_cast<const uint16_t*>(a.x) + i));
  return __ldg(static_cast<const float*>(a.x) + i);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) banded_pass(const Args a) {
  __shared__ float sth[kRows][kDepth];   // taps hi (exact: hi + lo)
  __shared__ float stl[kRows][kDepth];   // taps lo
  __shared__ __align__(16) float sxh[kDepth][kCols];  // input hi (exact: x)
  __shared__ __align__(16) float sxl[kDepth][kCols];  // input residual

  const int b = blockIdx.y / a.n_slices, sl = blockIdx.y % a.n_slices;
  const int r0 = sl * kRows;
  const int c0 = blockIdx.x * kCols;
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
  const int k_lo = a.k_range[2 * blockIdx.y];
  const int k_hi = a.k_range[2 * blockIdx.y + 1];
  const int row0 = a.offs[b];

  float acc[4][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += kDepth) {
    __syncthreads();
    for (int e = tid; e < kRows * kDepth; e += kThreads) {
      const int tr = r0 + e / kDepth, k = e % kDepth;
      float h = 0.0f, l = 0.0f;
      if (tr < a.t) {
        const size_t off = (static_cast<size_t>(b) * a.t + tr) * a.w + k0 + k;
        h = __bfloat162float(a.hi[off]);
        l = __bfloat162float(a.lo[off]);
      }
      if (MODE == kExact) {
        sth[e / kDepth][k] = __fadd_rn(h, l);
      } else {
        sth[e / kDepth][k] = h;
        stl[e / kDepth][k] = l;
      }
    }
    for (int e = tid; e < kDepth * kCols; e += kThreads) {
      const int k = e / kCols, col = e % kCols;
      const float v = load_x(a, row0 + k0 + k, c0 + col);
      if (MODE == kExact) {
        sxh[k][col] = v;
      } else {
        const float h = bf(v);
        sxh[k][col] = h;
        if (MODE == kSplit3) sxl[k][col] = bf(__fsub_rn(v, h));
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kDepth; ++k) {
      const float4 xh = *reinterpret_cast<const float4*>(&sxh[k][4 * tx]);
      const float xhv[4] = {xh.x, xh.y, xh.z, xh.w};
      float xlv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (MODE == kSplit3) {
        const float4 xl = *reinterpret_cast<const float4*>(&sxl[k][4 * tx]);
        xlv[0] = xl.x; xlv[1] = xl.y; xlv[2] = xl.z; xlv[3] = xl.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float th = sth[4 * ty + i][k];
        const float tl = MODE == kExact ? 0.0f : stl[4 * ty + i][k];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[i][jj] = fmaf(th, xhv[jj], acc[i][jj]);
          if (MODE != kExact) acc[i][jj] = fmaf(tl, xhv[jj], acc[i][jj]);
          if (MODE == kSplit3) acc[i][jj] = fmaf(th, xlv[jj], acc[i][jj]);
        }
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
  const dim3 grid((r + kCols - 1) / kCols, b * n_slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kSplit2) {
    banded_pass<kSplit2><<<grid, kThreads, 0, s>>>(a);
  } else if (mode == kSplit3) {
    banded_pass<kSplit3><<<grid, kThreads, 0, s>>>(a);
  } else {
    banded_pass<kExact><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
