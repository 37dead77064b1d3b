// Lane-contracting banded pass (K3) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// avir_tpu/ops/pallas/lanes_kernel.py: apply_lanes_pallas -> _kernel.
// For each lane block b of a lane-blocked operator (ops/lanes.py):
//
//   out[:, b*TC : (b+1)*TC] = x[:, offs_l[b] : offs_l[b] + WC] @ taps[b]
//
// with x [rows, lanes_in] interleaved (u8, u16 or f32, converted as it is
// staged; lanes past lanes_in read 0) and out f32 [rows, lanes_out] in the
// final interleaved layout.
//
// Modes (the same function as the TPU kernel, summed in another order):
//   split2  sum bf16(x) * (hi + lo)
//   split3  ... + bf16(x - f32(bf16(x))) * hi     (round to nearest even)
// Every product is bf16 x bf16, exact in float32, added by fmaf.
//
// Skipping the zeros.  The dense tap block [WC, TC] is channel-diagonal
// (an output lane of channel ch reads only input lanes of channel ch:
// two thirds of the entries are zero at C = 3) and banded.  The host
// (ops/cuda/lanes_kernel.py) keeps each output lane's nonzero diagonal
// only: the input lane first[j] of its first nonzero tap and kp taps at a
// stride of C lanes, ctaps[q][j] = taps[b][first[j] - offs_l[b] + q*C][j]
// (zero past the band).  The kernel computes
//
//   out[r, b*TC + j] = sum_q x[r, first[j] + q*C] * ctaps[q][j]
//
// which drops only zero products.
//
// Design.  A thread block owns 32 rows and one 128-lane output chunk of
// one lane block; thread (lane, half) accumulates 16 rows of one output
// lane in registers.  The chunk's input window [win_lo, win_hi) (its
// lanes' first..last taps) is staged 128 lanes at a time as a bf16 hi/lo
// split into 32 KB of static shared memory; each lane then walks the taps
// that fall into the segment, reads its tap pair once from device memory
// (coalesced across the warp) and applies it to its 16 rows.
//
// What bounds it on this card.  The input read once and the float32
// output written once: memory-bound at the unfused main-path shapes
// (3.35 TB/s; e.g. 1080 x 5760 u8 in, 1080 x 11520 f32 out: 56 MB,
// 17 us); its MACs (kp per output, 2-3 products each) are microseconds at
// the bf16 tensor-core rate.  This first version issues 2-3 fmaf per MAC
// on the CUDA cores with one shared-memory read per row and tap, so it is
// bound by issue and shared-memory reads, above that bound.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;     // rows per block
constexpr int kLanes = 128;   // output lanes per block (one chunk)
constexpr int kSeg = 128;     // input lanes staged per step
constexpr int kRowsPerThread = kRows / (kThreads / kLanes);

struct Args {
  const void* x;
  int in_kind;                // 0 u8, 1 u16, 2 f32
  int rows, lanes_in;         // x is [rows, lanes_in]
  float* out;                 // [rows, lanes_out]
  int lanes_out;
  const int32_t* first;       // [Bh, tcp] input lane of each output lane's tap 0
  const __nv_bfloat16* hi;    // [Bh, kp, tcp] compact taps
  const __nv_bfloat16* lo;
  const int32_t* win;         // [Bh * n_ch, 2] input lanes [lo, hi) of each chunk
  int n_ch, tc, tcp, kp, c;
};

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_x(const Args& a, int row, int lane) {
  if (row >= a.rows || lane >= a.lanes_in) return 0.0f;
  const size_t i = static_cast<size_t>(row) * a.lanes_in + lane;
  if (a.in_kind == 0) return static_cast<float>(__ldg(static_cast<const uint8_t*>(a.x) + i));
  if (a.in_kind == 1) return static_cast<float>(__ldg(static_cast<const uint16_t*>(a.x) + i));
  return __ldg(static_cast<const float*>(a.x) + i);
}

template <bool S3>
__global__ void __launch_bounds__(kThreads) lanes_pass(const Args a) {
  __shared__ float sxh[kRows][kSeg];
  __shared__ float sxl[S3 ? kRows : 1][kSeg];

  const int chunk = blockIdx.x;
  const int b = chunk / a.n_ch, jc = chunk % a.n_ch;
  const int r0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes, rg = (tid / kLanes) * kRowsPerThread;
  const int j = jc * kLanes + lane;  // column of block b, < tcp
  const int base = a.first[static_cast<size_t>(b) * a.tcp + j];
  const __nv_bfloat16* th = a.hi + static_cast<size_t>(b) * a.kp * a.tcp + j;
  const __nv_bfloat16* tl = a.lo + static_cast<size_t>(b) * a.kp * a.tcp + j;
  const int w_lo = a.win[2 * chunk], w_hi = a.win[2 * chunk + 1];

  float acc[kRowsPerThread] = {};
  for (int s0 = w_lo; s0 < w_hi; s0 += kSeg) {
    __syncthreads();
    for (int e = tid; e < kRows * kSeg; e += kThreads) {
      const int r = e / kSeg, l = e % kSeg;
      const float v = load_x(a, r0 + r, s0 + l);
      const float h = bf(v);
      sxh[r][l] = h;
      if (S3) sxl[r][l] = bf(__fsub_rn(v, h));
    }
    __syncthreads();
    const int d0 = s0 - base, d1 = s0 + kSeg - base;
    const int q0 = d0 <= 0 ? 0 : (d0 + a.c - 1) / a.c;
    const int q1 = d1 <= 0 ? 0 : min(a.kp, (d1 + a.c - 1) / a.c);
    for (int q = q0; q < q1; ++q) {
      const int li = base + q * a.c - s0;
      const float h = __bfloat162float(th[static_cast<size_t>(q) * a.tcp]);
      const float l = __bfloat162float(tl[static_cast<size_t>(q) * a.tcp]);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float xh = sxh[rg + i][li];
        acc[i] = fmaf(xh, h, acc[i]);
        acc[i] = fmaf(xh, l, acc[i]);
        if (S3) acc[i] = fmaf(sxl[rg + i][li], h, acc[i]);
      }
    }
  }
  const int col = b * a.tc + j;
  if (j >= a.tc || col >= a.lanes_out) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = r0 + rg + i;
    if (row < a.rows) a.out[static_cast<size_t>(row) * a.lanes_out + col] = acc[i];
  }
}

}  // namespace

extern "C" int avir_lanes(
    int split3, int in_kind,
    const void* x, int rows, int lanes_in,
    void* out, int lanes_out,
    const void* first, const void* hi, const void* lo, const void* win,
    int bh, int n_ch, int tc, int tcp, int kp, int c,
    void* stream) {
  Args a;
  a.x = x;
  a.in_kind = in_kind;
  a.rows = rows;
  a.lanes_in = lanes_in;
  a.out = static_cast<float*>(out);
  a.lanes_out = lanes_out;
  a.first = static_cast<const int32_t*>(first);
  a.hi = static_cast<const __nv_bfloat16*>(hi);
  a.lo = static_cast<const __nv_bfloat16*>(lo);
  a.win = static_cast<const int32_t*>(win);
  a.n_ch = n_ch;
  a.tc = tc;
  a.tcp = tcp;
  a.kp = kp;
  a.c = c;
  const dim3 grid(bh * n_ch, (rows + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split3) {
    lanes_pass<true><<<grid, kThreads, 0, s>>>(a);
  } else {
    lanes_pass<false><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
