// Error-diffusion wavefront scan (K4) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels
// avir_tpu/ops/pallas/wavefront_kernel.py: wavefront_scan_pallas (_kernel)
// and wavefront_scan_pallas_carry (_kernel_carry), the scan of
// avir_tpu/ops/dither.py:_wavefront_rows.  One launch quantizes a whole
// float32 image [H, W*C] with the reference's error diffusion
// (avir.h:4485-4525).  Pixel (y, x) of channel ch, at diagonal step
// t = 2y + x, takes
//
//   cur = ((((s + wr*n(y,x-1)) + wl*n(y-1,x+1)) + wc*n(y-1,x)) + wn*n(y-1,x-1))
//
// or, in the sum order of the JAX package's sequential nested scan
// (ops/dither.py:errdiff_dither_jnp, dither="errdiff-device"; SCAN):
//
//   cur = (s + ((wc*n(y-1,x) + wl*n(y-1,x+1)) + wn*n(y-1,x-1))) + wr*n(y,x-1)
//
// The two orders round differently, even at trunc_bits=0: isolated pixels
// of a small 16-bit image differ by one step, and a flip carries through
// the diffused noise (10% of a 1080p u8 image, PERF.md §6).  Then
//
//   z0  = round_biased(cur * tmi) * tm      (or round_biased(cur) when
//                                            tm == tmi == 1: bit-identical)
//   out = clamp(z0, 0, out_max) ;  n(y,x) = cur - z0, 0 outside 0 <= x < W
//
// with every product and sum rounded on its own (_rn intrinsics: no FMA
// contraction), so the result is bit-equal to the plain PyTorch version,
// whatever the grouping of rows.
//
// Design.  The skewed planar layout S[T, C*R] and the (8, G) sublane
// packing of the TPU kernel exist for the TPU's vector unit and are not
// carried over.  The image is cut into groups of R rows; one thread block
// of R*C threads, one per (row, channel), runs each group, and all groups
// run at once, in one launch.  At local step t, thread (y, ch) handles
// x = t - 2y; its own left neighbour's noise stays in a register.
//   - Inside a group: every thread keeps its last four steps' noise in a
//     shared-memory ring, with one __syncthreads per step; row y reads row
//     y-1's entries.  The steps of a chunk have no branch; their outputs
//     are stored after the chunk.
//   - Between groups: a block takes its group index from an atomicAdd
//     ticket at entry, not from blockIdx, so it only ever waits on a group
//     whose block is already running: no deadlock at any grid size or
//     residency, and no cooperative launch.  The last row of group g
//     writes each noise value to slot g of a device buffer [groups, W*C]
//     as one 64-bit word (the float's bits and a "written" bit) with a
//     relaxed store at device scope; row 0 of group g+1 reads the words a
//     chunk ahead with relaxed loads and, when it reaches them, reloads any
//     word still unwritten until it is.  A word is read whole or not at
//     all, so no fence and no flag round trip sits on the chain
//     (progress counters with a release store and an acquire poll per
//     chunk measured slower, PERF.md §6).  The entry point zeroes the
//     ticket and the buffer on the stream (cudaMemsetAsync) as part of
//     each resize.
//   - Image values (and row 0's noise words) for the next kAhead steps are
//     loaded one chunk ahead, so global latency stays off the recurrence.
//
// What bounds it on this card.  Not bytes (the image read once and the
// output written once take microseconds at 3.35 TB/s) and not arithmetic:
// the dependency chain.  The recurrence needs W + 2(H-1) steps in
// sequence, each a chain of ~15 dependent float operations plus the
// exchange with the row above (a barrier and the ring), and
// each group starts 2R + 2*kAhead steps after the group above (the
// recurrence's skew plus the load ahead), plus the time a written word
// takes to reach its reader.  Small groups make cheap steps but many
// hand-offs; large groups the reverse (chip_smoke.py sweeps R).

// Built without --use_fast_math: floorf and the _rn intrinsics keep the
// arithmetic IEEE.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kAhead = 8;  // steps per chunk, loaded one chunk ahead

struct Args {
  const float* img;   // [H, W*C]
  void* out;          // [H, W*C] float32, uint8 or uint16
  int h, w, c, rows;  // image extent; rows per group (R)
  // [groups, W*C]: each group's last-row noise, one word per value: the
  // float's bits, and kWritten once written (the wrapper zeroes it).
  unsigned long long* noise;
  int* ticket;        // [1]: the next group to start
  float tm, tmi, out_max;
  float wr, wl, wc, wn;  // cur right, next left, next center, next right
};

constexpr unsigned long long kWritten = 1ull << 32;

__device__ __forceinline__ float round_biased(float v) {
  return v >= 0.0f ? floorf(__fadd_rn(v, 0.5f)) : -floorf(__fsub_rn(0.5f, v));
}

// A noise word is read and written as one relaxed 64-bit access at device
// scope: a reader sees either zero (not yet written) or the whole word.
__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p, float v) {
  const unsigned long long word = kWritten | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(word) : "memory");
}

// Inputs of steps t0 .. t0+kAhead-1: the pixel value (0 off the row) and,
// for row 0 below another group, that group's last-row noise word at
// x + 1 (a written zero off the row), checked only when used.
__device__ __forceinline__ void fetch(
    const Args& a, const float* src, const unsigned long long* n_up, int y, int t0,
    float (&s)[kAhead], unsigned long long (&h)[kAhead]) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int x = t0 + k - 2 * y;
    s[k] = (x >= 0 && x < a.w) ? __ldg(src + static_cast<size_t>(x) * a.c) : 0.0f;
    h[k] = (n_up != nullptr && x + 1 < a.w) ? load_word(n_up + (x + 1) * a.c) : kWritten;
  }
}

// Row 0 below another group: reload each noise word of steps t0 ..
// t0+kAhead-1 that was not yet written when fetched, until it is.
__device__ __forceinline__ void await_words(
    const Args& a, const unsigned long long* n_up, int t0, unsigned long long (&h)[kAhead]) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    while (!(h[k] & kWritten)) h[k] = load_word(n_up + (t0 + k + 1) * a.c);
  }
}

// OUT: 0 float32, 1 uint8, 2 uint16 (a template parameter, so that the
// chunk's stores need no branch on it).
template <int OUT>
__device__ __forceinline__ void store(const Args& a, size_t i, float z0) {
  const float v = fminf(fmaxf(z0, 0.0f), a.out_max);
  if constexpr (OUT == 0) {
    static_cast<float*>(a.out)[i] = v;
  } else if constexpr (OUT == 1) {
    static_cast<uint8_t*>(a.out)[i] = static_cast<uint8_t>(static_cast<int>(v));
  } else {
    static_cast<uint16_t*>(a.out)[i] = static_cast<uint16_t>(static_cast<int>(v));
  }
}

// R*C threads, one per (row, channel).  OUT: the output type (store);
// SCAN: the sequential scan's sum order (see the top of the file).
template <int OUT, bool SCAN>
__global__ void __launch_bounds__(kMaxThreads) wavefront(const Args a) {
  __shared__ float ring[4][kMaxThreads];
  __shared__ int group;
  const int tid = threadIdx.x;
  if (tid == 0) group = atomicAdd(a.ticket, 1);
#pragma unroll
  for (int s = 0; s < 4; ++s) ring[s][tid] = 0.0f;
  __syncthreads();
  const int g = group;
  const int row0 = g * a.rows;
  const int rg = min(a.rows, a.h - row0);  // rows of this group
  const int y = tid / a.c, ch = tid % a.c;
  const bool active = y < rg;  // threads past the group's rows only follow
  const bool top = y == 0 && g > 0;
  const bool publish = y == rg - 1 && g + 1 < static_cast<int>(gridDim.x);
  const int wc = a.w * a.c;
  const int steps = 2 * (rg - 1) + a.w;
  const size_t row = static_cast<size_t>(row0 + (active ? y : 0)) * wc;
  const float* src = a.img + row + ch;
  const unsigned long long* n_up =
      top ? a.noise + static_cast<size_t>(g - 1) * wc + ch : nullptr;
  unsigned long long* n_own = a.noise + static_cast<size_t>(g) * wc + ch;
  const bool unit = a.tm == 1.0f && a.tmi == 1.0f;
  const int up = max(tid - a.c, 0);  // the thread of row y-1

  float n1 = 0.0f;  // own noise at the previous step: (y, x-1)
  // Row 0: the noise above at x and x-1 (d1 of the last two steps).
  float hp1 = 0.0f, hp2 = 0.0f;
  if (top) {
    unsigned long long w0 = load_word(n_up);
    while (!(w0 & kWritten)) w0 = load_word(n_up);
    hp1 = __uint_as_float(static_cast<unsigned>(w0));
  }
  float s_cur[kAhead], s_nxt[kAhead], z[kAhead], n[kAhead];
  unsigned long long h_cur[kAhead], h_nxt[kAhead];
  fetch(a, src, n_up, y, 0, s_cur, h_cur);
  for (int t0 = 0; t0 < steps; t0 += kAhead) {
    fetch(a, src, n_up, y, t0 + kAhead, s_nxt, h_nxt);
    if (top) await_words(a, n_up, t0, h_cur);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int t = t0 + k;
      const int x = t - 2 * y;
      // The row above at steps t-1, t-2, t-3: (y-1, x+1), (y-1, x),
      // (y-1, x-1); for row 0 the group above's last row.
      const float d1 = y == 0 ? __uint_as_float(static_cast<unsigned>(h_cur[k]))
                              : ring[(t + 3) & 3][up];
      const float d2 = y == 0 ? hp1 : ring[(t + 2) & 3][up];
      const float d3 = y == 0 ? hp2 : ring[(t + 1) & 3][up];
      hp2 = hp1;
      hp1 = d1;
      float cur;
      if constexpr (SCAN) {
        float up3 = __fadd_rn(__fmul_rn(a.wc, d2), __fmul_rn(a.wl, d1));
        up3 = __fadd_rn(up3, __fmul_rn(a.wn, d3));
        cur = __fadd_rn(__fadd_rn(s_cur[k], up3), __fmul_rn(a.wr, n1));
      } else {
        cur = __fadd_rn(s_cur[k], __fmul_rn(a.wr, n1));
        cur = __fadd_rn(cur, __fmul_rn(a.wl, d1));
        cur = __fadd_rn(cur, __fmul_rn(a.wc, d2));
        cur = __fadd_rn(cur, __fmul_rn(a.wn, d3));
      }
      const float z0 = unit ? round_biased(cur)
                            : __fmul_rn(round_biased(__fmul_rn(cur, a.tmi)), a.tm);
      const bool valid = active && x >= 0 && x < a.w;
      const float noise = valid ? __fsub_rn(cur, z0) : 0.0f;
      ring[t & 3][tid] = noise;
      __syncthreads();
      n1 = noise;
      z[k] = z0;
      n[k] = noise;
    }
    // The chunk's outputs (and the last row's noise words), stored after
    // its steps so that no branch sits between two steps' exchanges.
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int x = t0 + k - 2 * y;
      if (active && x >= 0 && x < a.w) {
        store<OUT>(a, row + static_cast<size_t>(x) * a.c + ch, z[k]);
        if (publish) store_word(n_own + x * a.c, n[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      s_cur[k] = s_nxt[k];
      h_cur[k] = h_nxt[k];
    }
  }
}

}  // namespace

extern "C" int avir_wavefront(
    const void* img, void* out, int out_kind,
    int h, int w, int c, int rows,
    void* noise, void* ticket,
    float tm, float tmi, float out_max,
    float wr, float wl, float wc, float wn, int scan,
    void* stream) {
  const int threads = rows * c;
  if (h < 1 || w < 1 || c < 1 || rows < 1 || threads > kMaxThreads || out_kind < 0 ||
      out_kind > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (h + rows - 1) / rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(ticket, 0, sizeof(int), s);
  if (e == cudaSuccess) {
    e = cudaMemsetAsync(noise, 0, sizeof(unsigned long long) * groups * static_cast<size_t>(w) * c, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  a.img = static_cast<const float*>(img);
  a.out = out;
  a.h = h;
  a.w = w;
  a.c = c;
  a.rows = rows;
  a.noise = static_cast<unsigned long long*>(noise);
  a.ticket = static_cast<int*>(ticket);
  a.tm = tm;
  a.tmi = tmi;
  a.out_max = out_max;
  a.wr = wr;
  a.wl = wl;
  a.wc = wc;
  a.wn = wn;
  if (scan) {
    if (out_kind == 0) {
      wavefront<0, true><<<groups, threads, 0, s>>>(a);
    } else if (out_kind == 1) {
      wavefront<1, true><<<groups, threads, 0, s>>>(a);
    } else {
      wavefront<2, true><<<groups, threads, 0, s>>>(a);
    }
  } else if (out_kind == 0) {
    wavefront<0, false><<<groups, threads, 0, s>>>(a);
  } else if (out_kind == 1) {
    wavefront<1, false><<<groups, threads, 0, s>>>(a);
  } else {
    wavefront<2, false><<<groups, threads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
