// Error-diffusion wavefront scan (K4) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels
// avir_tpu/ops/pallas/wavefront_kernel.py: wavefront_scan_pallas (_kernel)
// and wavefront_scan_pallas_carry (_kernel_carry), the scan of
// avir_tpu/ops/dither.py:_wavefront_rows.  One launch quantizes one block
// of rows of a float32 image [H, W*C] with the reference's error
// diffusion (avir.h:4485-4525).  Pixel (y, x) of channel ch, at
// diagonal step t = 2y + x, takes
//
//   cur = ((((s + wr*n(y,x-1)) + wl*n(y-1,x+1)) + wc*n(y-1,x)) + wn*n(y-1,x-1))
//   z0  = round_biased(cur * tmi) * tm      (or round_biased(cur) when
//                                            tm == tmi == 1: bit-identical)
//   out = clamp(z0, 0, out_max) ;  n(y,x) = cur - z0, 0 outside 0 <= x < W
//
// with every product and sum rounded on its own (_rn intrinsics: no FMA
// contraction), so the result is bit-equal to the plain PyTorch version.
// Row 0 of the block reads the previous block's last-row noise (n_in,
// zeros for the top block); the block writes its own last row's noise
// to n_out for the next launch.
//
// Design.  The skewed planar layout S[T, C*R] and the (8, G) sublane
// packing of the TPU kernel exist for the TPU's vector unit and are not
// carried over.  One CTA of R*C <= 1024 threads, one per (row, channel),
// reads the image in place: at step t, thread (y, ch) handles x = t - 2y.
// The last four steps' noise of every thread sits in a shared-memory
// ring, so a thread reads its upper neighbour's noise at t-1, t-2, t-3
// after one __syncthreads per step; its own left neighbour's noise stays
// in a register.  Image values (and row 0's carried noise) for the next
// kAhead steps are loaded one chunk ahead, so global latency stays off
// the recurrence.
//
// What bounds it on this card.  Not bytes (the image read once and the
// output written once take microseconds at 3.35 TB/s) and not arithmetic:
// the dependency chain.  A launch runs W + 2(R-1) steps in sequence and
// the blocks run in sequence, (H/R)(W + 2R) steps in all (~10,400 at
// 1920x1080, C = 3, R = 341), each a __syncthreads plus a chain of ~15
// dependent float operations on one SM.  The design keeps the chain
// short (ring in shared memory, loads ahead); running row blocks
// concurrently on several SMs with progress flags is the way further
// down, in a later change.
//
// Built without --use_fast_math: floorf and the _rn intrinsics keep the
// arithmetic IEEE.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kAhead = 8;  // steps whose inputs are loaded one chunk ahead

struct Args {
  const float* img;   // [H, W*C]
  void* out;          // [H, W*C] float32, uint8 or uint16
  int out_kind;       // 0 float32, 1 uint8, 2 uint16
  int w, c, row0, rb;
  const float* n_in;  // [W*C] previous block's last-row noise
  float* n_out;       // [W*C] this block's last-row noise
  float tm, tmi, out_max;
  float wr, wl, wc, wn;  // cur right, next left, next center, next right
};

__device__ __forceinline__ float round_biased(float v) {
  return v >= 0.0f ? floorf(__fadd_rn(v, 0.5f)) : -floorf(__fsub_rn(0.5f, v));
}

// Inputs of steps t0 .. t0+kAhead-1: the pixel value (0 off the row) and,
// for row 0, the previous block's noise at x + 1.
__device__ __forceinline__ void fetch(
    const Args& a, const float* src, int y, int ch, int t0,
    float (&s)[kAhead], float (&h)[kAhead]) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int x = t0 + k - 2 * y;
    s[k] = (x >= 0 && x < a.w) ? __ldg(src + static_cast<size_t>(x) * a.c) : 0.0f;
    h[k] = (y == 0 && x + 1 < a.w) ? __ldg(a.n_in + (x + 1) * a.c + ch) : 0.0f;
  }
}

__device__ __forceinline__ void store(const Args& a, size_t i, float z0) {
  const float v = fminf(fmaxf(z0, 0.0f), a.out_max);
  if (a.out_kind == 0) {
    static_cast<float*>(a.out)[i] = v;
  } else if (a.out_kind == 1) {
    static_cast<uint8_t*>(a.out)[i] = static_cast<uint8_t>(static_cast<int>(v));
  } else {
    static_cast<uint16_t*>(a.out)[i] = static_cast<uint16_t>(static_cast<int>(v));
  }
}

__global__ void __launch_bounds__(kMaxThreads) wavefront_block(const Args a) {
  __shared__ float ring[4][kMaxThreads];
  const int tid = threadIdx.x;
  const int y = tid / a.c, ch = tid % a.c;
  const int wc = a.w * a.c;
  const int steps = 2 * (a.rb - 1) + a.w;
  const size_t row = static_cast<size_t>(a.row0 + y) * wc;
  const float* src = a.img + row + ch;
  const bool unit = a.tm == 1.0f && a.tmi == 1.0f;
#pragma unroll
  for (int s = 0; s < 4; ++s) ring[s][tid] = 0.0f;
  __syncthreads();

  float n1 = 0.0f;  // this thread's noise at the previous step: (y, x-1)
  // Row 0 only: the carried noise at x and x-1 (d1 of the last two steps).
  float hp1 = (a.w > 0) ? __ldg(a.n_in + ch) : 0.0f, hp2 = 0.0f;
  float s_cur[kAhead], h_cur[kAhead], s_nxt[kAhead], h_nxt[kAhead];
  fetch(a, src, y, ch, 0, s_cur, h_cur);
  for (int t0 = 0; t0 < steps; t0 += kAhead) {
    fetch(a, src, y, ch, t0 + kAhead, s_nxt, h_nxt);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int t = t0 + k;
      const int x = t - 2 * y;
      float d1, d2, d3;
      if (y == 0) {
        d1 = h_cur[k];
        d2 = hp1;
        d3 = hp2;
        hp2 = hp1;
        hp1 = d1;
      } else {
        const int up = tid - a.c;
        d1 = ring[(t + 3) & 3][up];  // step t-1: (y-1, x+1)
        d2 = ring[(t + 2) & 3][up];  // step t-2: (y-1, x)
        d3 = ring[(t + 1) & 3][up];  // step t-3: (y-1, x-1)
      }
      float cur = __fadd_rn(s_cur[k], __fmul_rn(a.wr, n1));
      cur = __fadd_rn(cur, __fmul_rn(a.wl, d1));
      cur = __fadd_rn(cur, __fmul_rn(a.wc, d2));
      cur = __fadd_rn(cur, __fmul_rn(a.wn, d3));
      const float z0 = unit ? round_biased(cur)
                            : __fmul_rn(round_biased(__fmul_rn(cur, a.tmi)), a.tm);
      const bool valid = x >= 0 && x < a.w;
      const float noise = valid ? __fsub_rn(cur, z0) : 0.0f;
      if (valid) {
        store(a, row + static_cast<size_t>(x) * a.c + ch, z0);
        if (y == a.rb - 1) a.n_out[x * a.c + ch] = noise;
      }
      ring[t & 3][tid] = noise;
      n1 = noise;
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      s_cur[k] = s_nxt[k];
      h_cur[k] = h_nxt[k];
    }
  }
}

}  // namespace

extern "C" int avir_wavefront_block(
    const void* img, void* out, int out_kind,
    int w, int c, int row0, int rb,
    const void* n_in, void* n_out,
    float tm, float tmi, float out_max,
    float wr, float wl, float wc, float wn,
    void* stream) {
  if (rb < 1 || c < 1 || rb * c > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.img = static_cast<const float*>(img);
  a.out = out;
  a.out_kind = out_kind;
  a.w = w;
  a.c = c;
  a.row0 = row0;
  a.rb = rb;
  a.n_in = static_cast<const float*>(n_in);
  a.n_out = static_cast<float*>(n_out);
  a.tm = tm;
  a.tmi = tmi;
  a.out_max = out_max;
  a.wr = wr;
  a.wl = wl;
  a.wc = wc;
  a.wn = wn;
  wavefront_block<<<1, rb * c, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
