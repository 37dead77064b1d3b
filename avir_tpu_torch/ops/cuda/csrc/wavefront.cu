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
// of R*C threads (rounded up to whole warps; the extra threads only
// follow), one per (row, channel) with tid = y*C + ch, runs each group, and
// all groups run at once, in one launch.  At local step t, thread (y, ch)
// handles x = t - 2y; its own left neighbour's noise stays in a register.
// Thread y reads the row above at step t-1, (y-1, x+1); (y-1, x) and
// (y-1, x-1) are what it read at steps t-1 and t-2, kept in registers.
//   - Inside a warp: the row above lane l is lane l - C, so each step takes
//     it with one __shfl_up_sync of the previous step's noise.  No shared
//     memory and no barrier.  A row's channels may straddle two warps: the
//     channels are independent chains.
//   - Between warps of a group: a lane whose row above lies in another warp
//     (lanes 0..C-1 for C <= 32) reads it from a ring of shared memory that
//     holds the last steps of the writing lanes (the last C of each warp).
//     Each word is the noise's bits and its step + 1, stored as one 64-bit
//     word in the step that computes it, so a reader sees the word whole or
//     an older one.  A reader loads a chunk's K words at once when it starts
//     the chunk, and reloads, all at once, those still older than their step
//     until none is: a warp runs about a chunk behind the warp above, and
//     waits on it once a chunk at most.  Each warp publishes at every chunk
//     the step it has read up to; a warp whose words another warp reads
//     checks that, a chunk ahead, before it overwrites a step the ring still
//     holds for it.  No __syncthreads in the step loop, and no branch that
//     only some lanes of a warp take: waits end by a vote (__all_sync) and
//     loads and stores are predicated, so the warp stays converged and its
//     shuffles never take the divergent path.
//   - Between groups: a block takes its group index from an atomicAdd
//     ticket at entry, not from blockIdx, so it only ever waits on a group
//     whose block is already running: no deadlock at any grid size or
//     residency, and no cooperative launch.  The last row of group g
//     writes each noise value to slot g of a device buffer [groups, W*C]
//     as one 64-bit word (the float's bits and a "written" bit) with a
//     relaxed store at device scope; row 0 of group g+1 reads the words a
//     chunk ahead with relaxed loads and, when it reaches them, reloads all
//     of the chunk's words still unwritten at once, until none is.  A word
//     is read whole or not at all, so no fence and no flag round trip sits
//     on the chain (progress counters with a release store and an acquire
//     poll per chunk measured slower, PERF.md §6).  The entry point zeroes
//     the ticket and the buffer on the stream (cudaMemsetAsync) as part of
//     each resize.
//   - A chunk's K steps are one block of straight-line code: the ring's
//     stores are predicated, not branched on; the outputs and the last row's
//     words are stored, predicated, after the chunk's steps, off the chain
//     (in the steps they measured slower); each register that holds an input is
//     reloaded after its last use for the same step of the next chunk
//     (image values and row 0's words a chunk ahead), and a value off the
//     row is replaced by 0 where it is used, so that no instruction
//     waits on a load issued late (a warp issues in order: a copy of the
//     next chunk's loaded values at the chunk's end, or a select on a value
//     just loaded, waited on the load).
//     kAhead steps a chunk, half as many at 1024 threads.
//   - Two instantiations by block size, each with launch bounds of its
//     own: up to 256 threads (the default groups) and up to 1024 (groups
//     of up to 32 warps); the wrapper picks by the block's threads.
//
// What bounds it on this card.  Not bytes (the image read once and the
// output written once take microseconds at 3.35 TB/s) and not arithmetic:
// the dependency chain.  The recurrence needs W + 2(H-1) steps in
// sequence, each a chain of ~15 dependent float operations plus the
// shuffle that brings the row above, and a warp issues its step's other
// instructions (addresses, loads, stores) in order around that chain; each
// warp boundary inside a group adds about a chunk, and each group starts
// 2R steps after the group above plus the time a written word takes to
// reach its reader and the chunk it is fetched ahead.  Small groups hand
// off through device memory more often; large ones put more warps on each
// of the SM's four schedulers (chip_smoke.py sweeps R; k4_phases.py splits
// a step by phase).

// Built without --use_fast_math: floorf and the _rn intrinsics keep the
// arithmetic IEEE.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmallThreads = 256;  // the default groups' instantiation
constexpr int kAhead = 8;   // steps per chunk, its inputs loaded a chunk ahead
constexpr int kRingSteps = 64;  // steps a warp ring holds (a power of two) ...
constexpr int kRingStepsMin = 16;  // ... or, where that would not fit, down to this
constexpr size_t kRingBytes = 200 * 1024;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kRingStepsMin > kAhead, "a writer waits for at most one chunk of its reader");

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
  int ring_mask;      // steps the warp ring holds, less one
};

constexpr unsigned long long kWritten = 1ull << 32;

__device__ __forceinline__ float round_biased(float v) {
  return v >= 0.0f ? floorf(__fadd_rn(v, 0.5f)) : -floorf(__fsub_rn(0.5f, v));
}

// The warp ring and the warps' progress: relaxed accesses at block scope,
// a 64-bit word whole or not at all.
__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int load_done(const int* p) {
  int v;
  asm volatile("ld.relaxed.cta.shared.s32 %0, [%1];" : "=r"(v) : "r"(smem(p)));
  return v;
}

__device__ __forceinline__ void store_done(int* p, int v) {
  asm volatile("st.relaxed.cta.shared.s32 [%0], %1;" ::"r"(smem(p)), "r"(v));
}

// The least step that the warps lo..hi have read this warp's ring up to.
__device__ __forceinline__ int progress(const int* done, int lo, int hi) {
  int v = load_done(done + lo);
  if (hi > lo) v = min(v, load_done(done + hi));  // at most two: C > 32
  return v;
}

// The image value at x, loaded from the nearest address on the row (no
// branch); off the row the caller takes 0 instead, where it uses the value,
// so that nothing waits on the load before then.
__device__ __forceinline__ float pixel(const Args& a, const float* src, int x) {
  return __ldg(src + static_cast<size_t>(min(max(x, 0), a.w - 1)) * a.c);
}

// Loads that a predicate turns off instead of a branch, each into its
// register in place (the old value stays where p is false), so that the
// warp never diverges and nothing waits on a load before its value is used.
// A noise word is read and written as one relaxed 64-bit access, at device
// scope between groups and at block scope in the ring: a reader sees the
// whole word or an older one (zero: not yet written).
__device__ __forceinline__ void load_word_if(bool p, const unsigned long long* q,
                                             unsigned long long& v) {
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %1, 0;\n"
               "\t@p ld.relaxed.gpu.global.u64 %0, [%2];\n\t}"
               : "+l"(v) : "r"(static_cast<int>(p)), "l"(q) : "memory");
}

__device__ __forceinline__ void load_ring_if(bool p, const unsigned long long* q,
                                             unsigned long long& v) {
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %1, 0;\n"
               "\t@p ld.relaxed.cta.shared.u64 %0, [%2];\n\t}"
               : "+l"(v) : "r"(static_cast<int>(p)), "r"(smem(q)));
}

// Row 0 below another group (top): that group's last-row noise words of
// steps t0 .. t0+K-1, at x + 1, checked only when used; a written zero off
// the row and in every other thread.
template <int K>
__device__ __forceinline__ void fetch_words(const Args& a, bool top,
                                            const unsigned long long* n_up, int t0,
                                            unsigned long long (&h)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    h[k] = kWritten;
    load_word_if(top && t0 + k + 1 < a.w, n_up + (t0 + k + 1) * a.c, h[k]);
  }
}

// Reload the noise words of steps t0 .. t0+K-1 that were not yet written
// when fetched, all of them in flight at once, until every one is.  Every
// lane of the warp runs the loop (a vote ends it), so the warp stays
// converged for the shuffles that follow.
template <int K>
__device__ __forceinline__ void await_words(
    const Args& a, const unsigned long long* n_up, int t0, unsigned long long (&h)[K]) {
  while (true) {
    bool written = true;
#pragma unroll
    for (int k = 0; k < K; ++k) written = written && (h[k] & kWritten);
    if (__all_sync(kFull, written)) return;
#pragma unroll
    for (int k = 0; k < K; ++k) load_word_if(!(h[k] & kWritten), n_up + (t0 + k + 1) * a.c, h[k]);
  }
}

// The row above in another warp (from_ring), steps t0 .. t0+K-1: the words
// its lane wrote at steps t0-1 .. t0+K-2 (step 0's is a zero), loaded at
// once; await_ring reloads those still older than their step, all at once,
// until none is.  Every lane runs the loop, as in await_words.
template <int K>
__device__ __forceinline__ void load_ring_words(bool from_ring, const unsigned long long* up,
                                                int slots, int mask, int t0,
                                                unsigned long long (&w)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    load_ring_if(from_ring && t0 + k > 0, up + ((t0 + k - 1) & mask) * slots, w[k]);
  }
}

template <int K>
__device__ __forceinline__ void await_ring(bool from_ring, const unsigned long long* up,
                                           int slots, int mask, int t0,
                                           unsigned long long (&w)[K]) {
  while (true) {
    bool written = true;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      written = written && (!from_ring || static_cast<int>(w[k] >> 32) == t0 + k);
    }
    if (__all_sync(kFull, written)) return;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      load_ring_if(from_ring && static_cast<int>(w[k] >> 32) != t0 + k,
                   up + ((t0 + k - 1) & mask) * slots, w[k]);
    }
  }
}

// Stores that a predicate turns off instead of a branch, so that a chunk's
// steps stay one block of straight-line code.
__device__ __forceinline__ void store_ring_if(bool p, unsigned long long* q, int t, float v) {
  const unsigned long long word =
      (static_cast<unsigned long long>(t + 1) << 32) | __float_as_uint(v);
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n"
               "\t@p st.relaxed.cta.shared.u64 [%0], %1;\n\t}" ::"r"(smem(q)), "l"(word),
               "r"(static_cast<int>(p)));
}

__device__ __forceinline__ void store_word_if(bool p, unsigned long long* q, float v) {
  const unsigned long long word = kWritten | __float_as_uint(v);
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n"
               "\t@p st.relaxed.gpu.global.u64 [%0], %1;\n\t}" ::"l"(q), "l"(word),
               "r"(static_cast<int>(p))
               : "memory");
}

// OUT: 0 float32, 1 uint8, 2 uint16.
template <int OUT>
__device__ __forceinline__ void store_if(bool p, const Args& a, size_t i, float z0) {
  const float v = fminf(fmaxf(z0, 0.0f), a.out_max);
  if constexpr (OUT == 0) {
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n"
                 "\t@p st.global.f32 [%0], %1;\n\t}" ::"l"(static_cast<float*>(a.out) + i),
                 "f"(v), "r"(static_cast<int>(p)));
  } else if constexpr (OUT == 1) {
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n"
                 "\t@p st.global.u8 [%0], %1;\n\t}" ::"l"(static_cast<uint8_t*>(a.out) + i),
                 "h"(static_cast<unsigned short>(static_cast<int>(v))),
                 "r"(static_cast<int>(p)));
  } else {
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n"
                 "\t@p st.global.u16 [%0], %1;\n\t}" ::"l"(static_cast<uint16_t*>(a.out) + i),
                 "h"(static_cast<unsigned short>(static_cast<int>(v))),
                 "r"(static_cast<int>(p)));
  }
}

// One thread per (row, channel), BOUND threads at most.  OUT: the output
// type (store_if); SCAN: the sequential scan's sum order (see the top of
// the file); UNIT: tm == tmi == 1, where round_biased(cur) alone gives the
// same bits as round_biased(cur * tmi) * tm.
template <int OUT, bool SCAN, bool UNIT, int BOUND>
__global__ void __launch_bounds__(BOUND) wavefront(const Args a) {
  // Steps a chunk: half as many at 1024 threads, whose 64 registers a
  // thread would not hold a chunk of kAhead's inputs and outputs.
  constexpr int K = BOUND > kSmallThreads ? kAhead / 2 : kAhead;
  // [ring steps][slots]: slot warp*m + j holds lane 32-m+j of that warp.
  extern __shared__ unsigned long long ring[];
  __shared__ int done[BOUND / 32];  // each warp: the step it has read the ring up to
  __shared__ int group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x;
  const int m = min(a.c, 32);  // the lanes of a warp that write the ring
  const int slots = (threads >> 5) * m;
  for (int i = tid; i < (a.ring_mask + 1) * slots; i += threads) ring[i] = 0;
  if (lane == 0) done[warp] = 0;
  if (tid == 0) group = atomicAdd(a.ticket, 1);
  __syncthreads();
  const int g = group;
  const int row0 = g * a.rows;
  const int rg = min(a.rows, a.h - row0);  // rows of this group
  const int y = tid / a.c, ch = tid % a.c;
  const bool active = y < rg;  // threads past the group's rows only follow
  const bool head = y == 0;    // the row above is the group above's last row
  const bool top = head && g > 0;
  const bool publish = y == rg - 1 && g + 1 < static_cast<int>(gridDim.x);
  // Where the row above comes from: the ring where it lies in another warp
  // of the group, else the shuffle; and whether the row below reads this
  // thread's noise from the ring.
  const int above = tid - a.c, below = tid + a.c;
  const bool from_ring = above >= 0 && (above >> 5) != warp;
  const bool to_ring = below < threads && (below >> 5) != warp;
  const bool shuffled = !head && !from_ring;
  const int shfl = min(a.c, 31);
  // The warps that read this warp's ring words (at most two).
  const int r_lo = (warp * 32 + 32 - m + a.c) >> 5;
  const int r_hi = min((warp * 32 + 31 + a.c) >> 5, (threads >> 5) - 1);
  const bool read = r_lo <= r_hi;
  const int ring_steps = a.ring_mask + 1;
  unsigned long long* const ring_own = ring + warp * m + lane - (32 - m);
  const unsigned long long* const ring_up =
      ring + (above >> 5) * m + (above & 31) - (32 - m);
  const int wc = a.w * a.c;
  const int steps = 2 * (rg - 1) + a.w;
  const size_t row = static_cast<size_t>(row0 + (active ? y : 0)) * wc;
  const float* src = a.img + row + ch;
  const unsigned long long* n_up =
      top ? a.noise + static_cast<size_t>(g - 1) * wc + ch : nullptr;
  unsigned long long* n_own = a.noise + static_cast<size_t>(g) * wc + ch;

  float n1 = 0.0f;  // own noise at the previous step: (y, x-1)
  // The row above's noise read at the last two steps (d1 of steps t-1 and
  // t-2); for row 0 below another group, (y-1, x) at step 0 is word 0.
  float p1 = 0.0f, p2 = 0.0f;
  {
    unsigned long long w0 = kWritten;  // a written zero but in row 0 below a group
    load_word_if(top, n_up, w0);
    while (!__all_sync(kFull, (w0 & kWritten) != 0)) load_word_if(!(w0 & kWritten), n_up, w0);
    p1 = __uint_as_float(static_cast<unsigned>(w0));
  }
  // Inputs a chunk ahead, each register reloaded after its last use for the
  // same step of the next chunk, so that no instruction waits on a load
  // issued late (a warp issues in order): s[k], the image value of step
  // t0 + k, reloaded in the step that used it; h[k], the group above's word
  // of that step, reloaded once the chunk has copied it.
  float s[K];
  unsigned long long h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] = pixel(a, src, k - 2 * y);
  fetch_words<K>(a, top, n_up, 0, h);
  for (int t0 = 0; t0 < steps; t0 += K) {
    store_done(done + warp, t0);
    int seen = read ? progress(done, r_lo, r_hi) : INT_MAX;
    await_words<K>(a, n_up, t0, h);
    // The row above where it is not the lane C before: the group above's
    // words, or the ring's.
    unsigned long long w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = from_ring ? 0ull : h[k];
    fetch_words<K>(a, top, n_up, t0 + K, h);
    load_ring_words<K>(from_ring, ring_up, slots, a.ring_mask, t0, w);
    await_ring<K>(from_ring, ring_up, slots, a.ring_mask, t0, w);
    float z[K], n[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = t0 + k;
      const int x = t - 2 * y;
      const float up = __shfl_up_sync(kFull, n1, shfl);
      // The row above at steps t-1, t-2, t-3: (y-1, x+1), (y-1, x),
      // (y-1, x-1); for row 0 the group above's last row.
      const float d1 = shuffled ? up : __uint_as_float(static_cast<unsigned>(w[k]));
      const float d2 = p1, d3 = p2;
      p2 = p1;
      p1 = d1;
      const bool on_row = x >= 0 && x < a.w;
      const float sx = on_row ? s[k] : 0.0f;
      float cur;
      if constexpr (SCAN) {
        float up3 = __fadd_rn(__fmul_rn(a.wc, d2), __fmul_rn(a.wl, d1));
        up3 = __fadd_rn(up3, __fmul_rn(a.wn, d3));
        cur = __fadd_rn(__fadd_rn(sx, up3), __fmul_rn(a.wr, n1));
      } else {
        cur = __fadd_rn(sx, __fmul_rn(a.wr, n1));
        cur = __fadd_rn(cur, __fmul_rn(a.wl, d1));
        cur = __fadd_rn(cur, __fmul_rn(a.wc, d2));
        cur = __fadd_rn(cur, __fmul_rn(a.wn, d3));
      }
      s[k] = pixel(a, src, x + K);
      float z0;
      if constexpr (UNIT) {
        z0 = round_biased(cur);
      } else {
        z0 = __fmul_rn(round_biased(__fmul_rn(cur, a.tmi)), a.tm);
      }
      const bool valid = active && on_row;
      const float noise = valid ? __fsub_rn(cur, z0) : 0.0f;
      store_ring_if(to_ring, ring_own + (t & a.ring_mask) * slots, t, noise);
      n1 = noise;
      z[k] = z0;
      n[k] = noise;
    }
    // The chunk's outputs (and the last row's noise words), stored after
    // its steps, off the chain of dependent steps.
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int x = t0 + k - 2 * y;
      const bool valid = active && x >= 0 && x < a.w;
      store_if<OUT>(valid, a, row + static_cast<size_t>(x) * a.c + ch, z[k]);
      store_word_if(valid && publish, n_own + x * a.c, n[k]);
    }
    // The next chunk writes steps up to t0 + 2K - 1 over those ring_steps
    // before; its readers must have read past them (a reader at chunk T
    // has read every step below T - 1).  Read early in the chunk, the
    // progress is rarely short.
    while (read && t0 + K < steps && seen < t0 + 2 * K + 1 - ring_steps) {
      seen = progress(done, r_lo, r_hi);
    }
  }
}

template <int OUT, bool SCAN, bool UNIT, int BOUND>
cudaError_t launch(const Args& a, int groups, int threads, size_t smem_bytes, cudaStream_t s) {
  // The block's static shared memory (done, group) counts against the
  // same 48 KB that a launch may take without the attribute.
  if (smem_bytes + 1024 > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(wavefront<OUT, SCAN, UNIT, BOUND>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return e;
  }
  wavefront<OUT, SCAN, UNIT, BOUND><<<groups, threads, smem_bytes, s>>>(a);
  return cudaGetLastError();
}

template <int OUT, bool SCAN>
cudaError_t launch_out(const Args& a, bool unit, int bound, int groups, int threads,
                       size_t smem_bytes, cudaStream_t s) {
  if (bound == kSmallThreads) {
    return unit ? launch<OUT, SCAN, true, kSmallThreads>(a, groups, threads, smem_bytes, s)
                : launch<OUT, SCAN, false, kSmallThreads>(a, groups, threads, smem_bytes, s);
  }
  return unit ? launch<OUT, SCAN, true, kMaxThreads>(a, groups, threads, smem_bytes, s)
              : launch<OUT, SCAN, false, kMaxThreads>(a, groups, threads, smem_bytes, s);
}

template <bool SCAN>
cudaError_t launch_scan(const Args& a, int out_kind, bool unit, int bound, int groups,
                        int threads, size_t smem_bytes, cudaStream_t s) {
  if (out_kind == 0) return launch_out<0, SCAN>(a, unit, bound, groups, threads, smem_bytes, s);
  if (out_kind == 1) return launch_out<1, SCAN>(a, unit, bound, groups, threads, smem_bytes, s);
  return launch_out<2, SCAN>(a, unit, bound, groups, threads, smem_bytes, s);
}

}  // namespace

// bound: the instantiation's launch bound, 256 or 1024 threads, at least
// rows * c (the wrapper picks the smaller that holds the block).
extern "C" int avir_wavefront(
    const void* img, void* out, int out_kind,
    int h, int w, int c, int rows,
    void* noise, void* ticket,
    float tm, float tmi, float out_max,
    float wr, float wl, float wc, float wn, int scan, int bound,
    void* stream) {
  if (h < 1 || w < 1 || c < 1 || rows < 1 || out_kind < 0 || out_kind > 2 ||
      (bound != kSmallThreads && bound != kMaxThreads) || rows * c > bound) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = (rows * c + 31) / 32 * 32;
  const int groups = (h + rows - 1) / rows;
  // The warp ring: as many steps as fit kRingBytes, from kRingSteps down.
  const size_t slot_bytes = sizeof(unsigned long long) * (threads / 32) * (c < 32 ? c : 32);
  int ring_steps = kRingSteps;
  while (ring_steps > kRingStepsMin && ring_steps * slot_bytes > kRingBytes) ring_steps /= 2;
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
  a.ring_mask = ring_steps - 1;
  const bool unit = tm == 1.0f && tmi == 1.0f;
  const size_t smem_bytes = ring_steps * slot_bytes;
  e = scan ? launch_scan<true>(a, out_kind, unit, bound, groups, threads, smem_bytes, s)
           : launch_scan<false>(a, out_kind, unit, bound, groups, threads, smem_bytes, s);
  return static_cast<int>(e);
}
