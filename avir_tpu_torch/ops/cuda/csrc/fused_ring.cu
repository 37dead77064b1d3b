// Shift-ring int8 sRGB-gamma resize (K6) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// avir_tpu/ops/pallas/fused_ring_kernel.py:137 apply_fused_ring_pallas ->
// _kernel (:87).  It computes the function of K1's int8 gamma route in
// order "vh" (fused_int8.cu with GAMMA): u8 sRGB [rows_in, lanes_in] -> u8
// [rows_out, lanes_out], bit for bit, by the same integer steps
// (k1_common.cuh: the q13 table of gamma_in_q13, limb_hi, requant,
// recombine, finish_int).
//
// What it saves.  K1 linearizes each input element every time a thread
// block stages it: 2.98 times per input byte at 7680x4320 -> 1920x1080.
// On the TPU the ring kernel keeps the linearized window of a column in
// VMEM across the sequential grid; a Hopper block has no sequential grid
// and 227 KB of shared memory, less than one chunk's window of limb rows.
// So the ring is kept per 128-lane input segment, and the segments of one
// output chunk are the blocks of one thread block cluster:
//
//   - A cluster owns one 128-lane output chunk and a run of consecutive
//     32-row output slices (a part of the column).  Each of its blocks owns
//     one 128-lane input segment of the chunk's window that holds nonzero
//     lane taps (the host's cluster plan, fused_ring.py) and keeps that
//     segment's linearized limb rows in a ring in shared memory (ring_rows
//     rows: the largest tap-row range of one slice, 192 at 8K), indexed by
//     absolute row mod ring_rows, in the B-fragment layout of the
//     tensor-core kernels: words of 4 consecutive rows, rows of 136 words
//     (128 lanes padded for the banks).  For the run's first slice a block
//     linearizes the slice's whole tap-row range (the preload), for each
//     next slice only the rows past the previous slice's end, one shared
//     table read an element (k1::fill_q13_table's entries, both limbs of
//     each packed in a u16).  Rows above the image
//     (pad_top of the uniform operator) and below it read as 0, whose
//     linearization is 0: no padded copy of the image.
//   - Per slice, the first (vertical) pass over the ring runs on the s8
//     tensor cores (mma.sync m16n8k32; the slice's V taps [q1; q0] by one
//     cp.async sequence issued as soon as the slice before has done its
//     first pass): m1 = q1 xq1, m0 = q0 xq1 + q1 xq0
//     (the first two share their B fragment), requantized (fq = 2^14 m1 +
//     2^7 m0) into the segment's 32 x 128 intermediate limbs in shared
//     memory.  The second (horizontal) pass multiplies them by the chunk's
//     lane taps of this segment (staged once a slice by cp.async, landing
//     during the first pass): pa = x1
//     h1, pb = x0 h1 + x1 h0, the segment's share of the chunk's 32 x 128
//     outputs, left in the block's shared memory.
//   - Cluster barrier, split into arrive and wait around the linearization
//     of the next slice's new rows.  Each block then sums its share of the
//     chunk's outputs (a 1/n range of the 4,096 elements) over every block
//     of the cluster, reading its peers' shares through distributed shared
//     memory (map_shared_rank), recombines, runs the gamma-out epilogue
//     and stores u8.  A second barrier keeps a block from overwriting
//     shares that a peer is still reading with the next slice's lane taps.
//   One launch does the whole resize, with no global atomics and no s32
//   buffer in device memory: the integer sums are exact in any order.
//   A segment in two chunks' windows is linearized by both clusters
//   (chip_smoke.py prints the factor: 1.56 at 8K, against K1's 2.98).
//
// Why the cluster sums shares of outputs and does not gather limbs.  A
// block reduces 32 KB of peers' s32 shares a slice whatever the cluster's
// size n; gathering every segment's limbs would move 8 n KB a block
// (48 KB at n = 6, 128 KB at 16), which ldmatrix cannot read in place
// from a peer and the shared memory could not hold beside a 512-row ring.
// The MMA work is the same either way.
//
// Shared memory (dynamic): the ring (2 x ring_rows/4 x 136 words: 52 KB at
// 192 rows, 139 KB at 512), the q13 table (2 KB), the slice's V taps (2 x
// 32 x (ring_rows + 16) bytes: 13 KB at 192 rows), the intermediate's
// limbs (9 KB) and the segment's lane taps (34 KB), which the shares
// overlay once the second pass is done: 109 KB at 8K, two blocks an SM;
// 214 KB at 512 rows.  8 warps; warp (wm, wn) owns rows 16 wm.. and lanes 32 wn..
// of both passes.  Clusters of up to 8 blocks are portable, up to 16
// allowed on the H100 (non-portable); the host refuses more.
//
// What bounds it on this card.  The image read once and the output
// written once: ~0.032 ms at 8K (3.35 TB/s), as for K1 int8 vh.  The
// design reads the image 1.56 times at 8K (two clusters share a segment),
// the lane taps once a block and slice from L2, and moves 32 KB of shares a
// block and slice through distributed shared memory.  Measured on an H100
// 80GB HBM3 at 700 W: 0.60-0.64 ms at 7680x4320 -> 1920x1080 and 0.23-0.24
// at 3840x2160 -> 1280x720 (chip_smoke.py), against 1.39-1.42 and 0.47-0.53
// for the design with global atomics it replaces; 19x the bound.  No unit
// is near its rate: a slice's chain of phases is the limit, ~25 K cycles
// (linearization ~6.4 K, reading the peers' shares ~4.8 K, the rest in the
// passes and barriers), which two blocks an SM overlap (one block an SM
// runs 1.7x slower; ring_phases.py measures both).
//
// Wrapping.  int8_feasible bounds 2^14 * 64 q_abs1 + 2^7 * 64 (q_abs1 +
// q_abs0) + 2^26 below 2^31, so no partial sum of m1 or m0 (|xq limbs| <=
// 64) and no fq wraps.  The second pass's shares may wrap (no .satfinite);
// the wrapped s32 total is the exact sum, as in K1.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "k1_common.cuh"
#include "mma_s8.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mma_s8;

constexpr int kThreads = 256;
constexpr int kRows = 32;     // output rows per slice
constexpr int kLanes = 128;   // lanes per input segment and per output chunk
constexpr int kDepth = 32;    // MMA depth
constexpr int kWn = 4;        // warps across lanes (2 x 4 warps)
constexpr int kWLd = kLanes + 8;       // ring and lane-tap row stride, words
constexpr int kILd = kLanes + 16;      // intermediate row stride, bytes
constexpr int kPLd = 8 * kLanes + 64;  // share row stride, bytes ({pa, pb} a lane)
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;

constexpr int kTable = 2 * 256 * (4 + 2);         // q13 [2][256] s32, limbs [2][256] u16
constexpr int kSi = 2 * kRows * kILd;             // limbs [2 limb][32][kILd]
constexpr int kSh = 2 * (kLanes / 4) * kWLd * 4;  // lane taps [2 limb][32][kWLd] words
static_assert(kRows * kPLd <= kSh, "the shares overlay the lane taps");

__host__ __device__ constexpr size_t ring_bytes(int ring_rows) {
  return static_cast<size_t>(2) * (ring_rows / 4) * kWLd * 4;
}

// A slice's V taps, [2 limb][32 rows][ring_rows + 16 bytes]: a row stride
// of an odd multiple of 16 bytes keeps ldmatrix free of bank conflicts.
__host__ __device__ constexpr int v_ld(int ring_rows) { return ring_rows + 16; }

__host__ __device__ constexpr size_t smem_bytes(int ring_rows) {
  return ring_bytes(ring_rows) + kTable + static_cast<size_t>(2) * kRows * v_ld(ring_rows) +
         kSi + kSh;
}

struct Args {
  const uint8_t* x;        // u8 image [rows_in, lanes_in]
  int rows_in, lanes_in;
  int pad_top;             // padded row r is image row r - pad_top
  bool vec4;               // image rows 4-byte aligned
  uint8_t* out;            // [rows_out, lanes_out]
  int rows_out, lanes_out, tc;
  const int8_t* v1;        // [Bv, Tv, Wv]
  const int8_t* v0;
  const int32_t* offs_v;   // [Bv] window starts, padded rows
  int tv, wv;
  const uint32_t* h1p;     // [Bh * n_ch, win_c/4, 128] packed along win_c
  const uint32_t* h0p;
  int n_ch, win_c;
  const int32_t* k_range;  // [Bv, n_slices, 2] nonzero V-tap rows, 32-aligned
  int n_slices;
  int cluster;             // blocks a cluster
  const int32_t* chunk_of; // [n_clusters] lane chunk hb * n_ch + j
  const int32_t* seg_of;   // [n_clusters * cluster] input segment, or -1
  const int32_t* off_of;   // [n_clusters * cluster] its first window lane
  const int4* slices;      // slices with output rows, in order: {vb * n_slices + sl,
                           // k_lo, k_hi (its nonzero V-tap rows), its window's row}
  const int32_t* part_ptr; // [parts + 1] runs of slices
  int ring_rows;
  int sh;
  float rec;
  k1::Epilogue epi;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Image word: 4 lanes l..l+3 of image row r, zero past the edges.
__device__ __forceinline__ uint32_t load4(const Args& a, int r, int l) {
  if (r < 0 || r >= a.rows_in) return 0u;
  const uint8_t* p = a.x + static_cast<size_t>(r) * a.lanes_in + l;
  if (a.vec4) return l < a.lanes_in ? __ldg(reinterpret_cast<const uint32_t*>(p)) : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (l + e < a.lanes_in) v |= static_cast<uint32_t>(__ldg(p + e)) << (8 * e);
  }
  return v;
}

// The block's tables: k1::fill_q13_table's q13 (gamma_in_q13 of every u8
// value, the alpha lane's in row 1), then each entry's two s8 limbs packed
// in a u16 (hi in the low byte), so that one read gives both.
__device__ __forceinline__ void fill_tables(const Args& a, int32_t (*q13)[256], uint16_t* limbs) {
  k1::fill_q13_table(a.epi, q13);
  for (int i = threadIdx.x; i < 512; i += kThreads) {
    const int32_t q = q13[i >> 8][i & 255], q1 = k1::limb_hi(q);
    limbs[i] = static_cast<uint16_t>((q1 & 0xff) | ((q - 128 * q1) & 0xff) << 8);
  }
  __syncthreads();
}

// Four rows' image words (lanes 4t..4t+3 of a segment each: lane i of a
// word is lane % 4 == i of the image, so tb[i] is that lane's table) as
// ring words of one row quad: w1 (hi limbs) / w0 (lo).
__device__ __forceinline__ void put_quad(const uint16_t* const (&tb)[4], const uint32_t (&raw)[4],
                                         uint32_t* w1, uint32_t* w0) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = tb[i][(raw[e] >> (8 * i)) & 0xffu];
    const uint32_t a01 = __byte_perm(v[0], v[1], 0x5140), a23 = __byte_perm(v[2], v[3], 0x5140);
    h[e] = __byte_perm(a01, a23, 0x5410);
    l[e] = __byte_perm(a01, a23, 0x7632);
  }
  *reinterpret_cast<uint4*>(w1) = transpose4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(w0) = transpose4(l[0], l[1], l[2], l[3]);
}

// Linearize padded rows [r0, r1) (multiples of 32) of the segment at lane
// ``lane`` into the ring: warp w takes row quads w, w + 8, ..., four a
// turn (16 image words in flight a thread: one turn for a slice's 128 new
// rows at 8K), thread t lanes 4t..4t+3.
__device__ __forceinline__ void fill_ring(const Args& a, const uint16_t* const (&tb)[4], int lane,
                                          int r0, int r1, uint32_t* ring1, uint32_t* ring0) {
  const int q = threadIdx.x % 32, gl = lane + 4 * q;
  for (int r = r0 + 4 * (threadIdx.x / 32); r < r1; r += 128) {
    uint32_t raw[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        raw[u][e] = r + 32 * u < r1 ? load4(a, r + 32 * u + e - a.pad_top, gl) : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r + 32 * u < r1) {
        const int slot = ((r + 32 * u) % a.ring_rows) / 4;
        put_quad(tb, raw[u], ring1 + slot * kWLd + 4 * q, ring0 + slot * kWLd + 4 * q);
      }
    }
  }
}

// V taps of rows r0..r0+31 of V block vb over window rows k0..k1-1 (rows
// past the block: 0), [2 limb][32][ld] bytes.
__device__ __forceinline__ void stage_v(const Args& a, uint8_t* sv, int ld, int vb, int r0,
                                        int k0, int k1) {
  const int per = (k1 - k0) / 16;
  for (int c = threadIdx.x; c < 2 * kRows * per; c += kThreads) {
    const int p = c / (kRows * per), r = (c / per) % kRows, part = c % per;
    const bool valid = r0 + r < a.tv;
    const size_t row = static_cast<size_t>(vb) * a.tv + (valid ? r0 + r : 0);
    cp16(sv + (p * kRows + r) * ld + part * 16, (p ? a.v0 : a.v1) + row * a.wv + k0 + part * 16,
         valid);
  }
}

// Lane-tap words of window lanes off..off+127 of chunk ``chunk``.
__device__ __forceinline__ void stage_h(const Args& a, uint32_t* sh, int chunk, int off) {
  for (int c = threadIdx.x; c < 2 * (kLanes / 4) * 32; c += kThreads) {
    const int p = c / ((kLanes / 4) * 32), w = (c / 32) % (kLanes / 4), part = c % 32;
    const size_t src = (static_cast<size_t>(chunk) * (a.win_c / 4) + off / 4 + w) * kLanes + part * 4;
    cp16(sh + (p * (kLanes / 4) + w) * kWLd + part * 4, (p ? a.h0p : a.h1p) + src, true);
  }
}

// Slice s's new rows of the block's segment into the ring (none when the
// slice has no nonzero V tap); returns the rows now filled up to.
__device__ __forceinline__ int fill_slice(const Args& a, const uint16_t* const (&tb)[4], int seg,
                                          int4 s, int done, uint32_t* ring1, uint32_t* ring0) {
  if (s.y >= s.z) return done;
  const int lo = s.w + s.y, hi = s.w + s.z;
  fill_ring(a, tb, seg * kLanes, done < 0 ? lo : max(done, lo), hi, ring1, ring0);
  return hi;
}

// Slice s's V taps, when it has any (one cp.async group).
__device__ __forceinline__ void stage_slice_v(const Args& a, uint8_t* sv, int ld, int4 s) {
  if (s.y >= s.z) return;
  stage_v(a, sv, ld, s.x / a.n_slices, (s.x % a.n_slices) * kRows, s.y, s.z);
  cp_commit();
}

// Output elements (row tr of V block vb, lanes cl..cl+3 of lane block hb)
// from their full sums {pa, pb, pa, pb} of lanes cl, cl + 1 and cl + 2,
// cl + 3.
__device__ __forceinline__ void store4(const Args& a, int vb, int tr, int hb, int cl,
                                       const int4& s0, const int4& s1) {
  const int orow = vb * a.tv + tr;
  if (tr >= a.tv || orow >= a.rows_out) return;
  const int32_t pa[4] = {s0.x, s0.z, s1.x, s1.z}, pb[4] = {s0.y, s0.w, s1.y, s1.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int olane = hb * a.tc + cl + e;
    if (cl + e < a.tc && olane < a.lanes_out) {
      const float acc = k1::recombine(pa[e], pb[e], a.rec);
      a.out[static_cast<size_t>(orow) * a.lanes_out + olane] =
          static_cast<uint8_t>(static_cast<int>(k1::finish_int<true>(a.epi, acc, olane)));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) fused_ring_vh(const Args a) {
  extern __shared__ __align__(16) uint8_t sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.cluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int cl = blockIdx.x / n;
  const int chunk = a.chunk_of[cl];
  const int hb = chunk / a.n_ch, j = chunk % a.n_ch;
  const int seg = a.seg_of[cl * n + rank];
  const int off = a.off_of[cl * n + rank];
  int n_valid = 0;  // blocks of the cluster that own a segment: ranks 0..n_valid-1
  for (int r = 0; r < n; ++r) n_valid += a.seg_of[cl * n + r] >= 0;

  uint32_t* ring1 = reinterpret_cast<uint32_t*>(sm);
  uint32_t* ring0 = ring1 + (a.ring_rows / 4) * kWLd;
  int32_t (*q13)[256] = reinterpret_cast<int32_t (*)[256]>(sm + ring_bytes(a.ring_rows));
  uint16_t* limbs = reinterpret_cast<uint16_t*>(sm + ring_bytes(a.ring_rows) + 2 * 256 * 4);
  const int ld = v_ld(a.ring_rows);
  uint8_t* sv = sm + ring_bytes(a.ring_rows) + kTable;
  uint8_t* si = sv + 2 * kRows * ld;
  uint32_t* sh = reinterpret_cast<uint32_t*>(si + kSi);
  uint8_t* sp = reinterpret_cast<uint8_t*>(sh);  // the shares, over the lane taps

  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int wm = warp / kWn, wn = warp % kWn;
  const int arow = lid & 15, acol = (lid >> 4) * 16;  // ldmatrix address of this thread
  const int g = lid / 4, t = lid % 4;                 // fragment row / column group
  // The element quads (4 lanes of a row) of the chunk's 32 x 128 outputs
  // this block finishes.
  constexpr int kQuads = kRows * kLanes / 4;
  const int e0 = rank * kQuads / n, e1 = (rank + 1) * kQuads / n;

  fill_tables(a, q13, limbs);
  const uint16_t* const tb[4] = {
      limbs + (a.epi.alpha_lane == 0 ? 256 : 0), limbs + (a.epi.alpha_lane == 1 ? 256 : 0),
      limbs + (a.epi.alpha_lane == 2 ? 256 : 0), limbs + (a.epi.alpha_lane == 3 ? 256 : 0)};
  const int p0 = a.part_ptr[blockIdx.y], p1 = a.part_ptr[blockIdx.y + 1];
  // Padded rows below ``done`` are in the ring (-1: none yet).  The run's
  // first slice's V taps and rows go in first; each next slice's V taps
  // once this slice's first pass is done, its rows while the cluster
  // finishes this slice.
  int done = -1;
  int4 cur = p0 < p1 ? __ldg(a.slices + p0) : make_int4(0, 0, 0, 0);
  if (seg >= 0 && p0 < p1) {
    stage_slice_v(a, sv, ld, cur);
    done = fill_slice(a, tb, seg, cur, done, ring1, ring0);
  }
  for (int p = p0; p < p1; ++p) {
    const int4 nxt = p + 1 < p1 ? __ldg(a.slices + p + 1) : cur;
    const bool more = seg >= 0 && p + 1 < p1;  // this block fills a next slice
    const int vb = cur.x / a.n_slices, r0 = (cur.x % a.n_slices) * kRows;
    const int row0 = cur.w, k_lo = cur.y, k_hi = cur.z;
    // The slice's nonzero V taps and the block's segment (uniform in the
    // block; the slice is the same for the whole cluster).
    const bool active = k_lo < k_hi;
    const bool work = active && seg >= 0;
    if (p > p0) cluster_wait();  // the peers have read this block's last shares
    if (work) {
      stage_h(a, sh, chunk, off);  // lands during the first pass
      cp_commit();
      cp_wait_one();
      __syncthreads();
      // ---- first (vertical) pass: m1 = q1 xq1, m0 = q0 xq1 + q1 xq0 ----
      int32_t m1[4][4] = {}, m0[4][4] = {};
      for (int kk = 0; kk < k_hi - k_lo; kk += kDepth) {
        uint32_t q1[4], q0[4];
        ldsm(q1, sv + (16 * wm + arow) * ld + kk + acol);
        ldsm(q0, sv + (kRows + 16 * wm + arow) * ld + kk + acol);
        // A 32-row group is contiguous in the ring: rows and ring_rows are
        // multiples of 32.
        const int slot = ((row0 + k_lo + kk) % a.ring_rows) / 4;
        const uint32_t* x1 = ring1 + slot * kWLd;
        const uint32_t* x0 = ring0 + slot * kWLd;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 32 * wn + 8 * c + g;
          const uint32_t b0 = x1[t * kWLd + col], b1 = x1[(t + 4) * kWLd + col];
          const uint32_t c0 = x0[t * kWLd + col], c1 = x0[(t + 4) * kWLd + col];
          mma8(m1[c], q1, b0, b1);
          mma8(m0[c], q0, b0, b1);
          mma8(m0[c], q1, c0, c1);
        }
      }
      // ---- requantize into the intermediate's limbs --------------------
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 32 * wn + 8 * c + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wm + g + 8 * h;
          limbs2(m1[c][2 * h] * 16384 + m0[c][2 * h] * 128,
                 m1[c][2 * h + 1] * 16384 + m0[c][2 * h + 1] * 128, a.sh,
                 si + r * kILd + col, si + (kRows + r) * kILd + col);
        }
      }
      cp_wait_all();
      __syncthreads();
      if (more) stage_slice_v(a, sv, ld, nxt);  // no warp reads this slice's taps now
      // ---- second (horizontal) pass: this segment's share --------------
      int32_t pa[4][4] = {}, pb[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < kLanes; kk += kDepth) {
        uint32_t x1[4], x0[4];
        ldsm(x1, si + (16 * wm + arow) * kILd + kk + acol);
        ldsm(x0, si + (kRows + 16 * wm + arow) * kILd + kk + acol);
        const uint32_t* h1 = sh + (kk / 4) * kWLd;
        const uint32_t* h0 = h1 + (kLanes / 4) * kWLd;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 32 * wn + 8 * c + g;
          const uint32_t b10 = h1[t * kWLd + col], b11 = h1[(t + 4) * kWLd + col];
          const uint32_t b00 = h0[t * kWLd + col], b01 = h0[(t + 4) * kWLd + col];
          mma8(pa[c], x1, b10, b11);
          mma8(pb[c], x0, b10, b11);
          mma8(pb[c], x1, b00, b01);
        }
      }
      __syncthreads();  // every warp is done with the lane taps
      // The share (row g (+8), lanes 2t, 2t+1 of tile c), over the taps.
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int l = 32 * wn + 8 * c + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wm + g + 8 * h;
          *reinterpret_cast<int4*>(sp + r * kPLd + 8 * l) =
              make_int4(pa[c][2 * h], pb[c][2 * h], pa[c][2 * h + 1], pb[c][2 * h + 1]);
        }
      }
    } else if (more) {
      stage_slice_v(a, sv, ld, nxt);
    }
    cluster_arrive();
    // The next slice's new rows (the ring rows this slice read are done),
    // while the peers finish their shares.
    if (more) done = fill_slice(a, tb, seg, nxt, done, ring1, ring0);
    cluster_wait();  // every block's share of this slice is in place
    // ---- this block's outputs: the shares summed over the cluster ------
    for (int e = e0 + static_cast<int>(threadIdx.x); e < e1; e += kThreads) {
      const int r = 4 * e / kLanes, l = 4 * e % kLanes;
      int4 s0 = make_int4(0, 0, 0, 0), s1 = s0;
      if (active) {
        // Every peer's two words issued before any is summed.
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q) {
          if (q < n_valid) {
            const int4* v = reinterpret_cast<const int4*>(
                cluster.map_shared_rank(sp + r * kPLd + 8 * l, q));
            const int4 v0 = v[0], v1 = v[1];
            s0 = make_int4(s0.x + v0.x, s0.y + v0.y, s0.z + v0.z, s0.w + v0.w);
            s1 = make_int4(s1.x + v1.x, s1.y + v1.y, s1.z + v1.z, s1.w + v1.w);
          }
        }
      }
      store4(a, vb, r0 + r, hb, j * kLanes + l, s0, s1);
    }
    cluster_arrive();  // done reading the peers' shares
    cur = nxt;
  }
  if (p1 > p0) cluster_wait();  // no block leaves while a peer may read its shares
}

cudaError_t set_attributes(int cluster, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(fused_ring_vh, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e == cudaSuccess && cluster > 8) {
    e = cudaFuncSetAttribute(fused_ring_vh, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return e;
}

cudaLaunchConfig_t config(dim3 grid, size_t bytes, cudaStream_t s, cudaLaunchAttribute* attr,
                          int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Dynamic shared memory of one block at ``ring_rows`` (fused_ring.py
// mirrors it).
extern "C" int avir_fused_ring_smem(int ring_rows) {
  return static_cast<int>(smem_bytes(ring_rows));
}

// Clusters of ``cluster`` blocks at ``ring_rows`` the card can hold at
// once, into *count (0: it cannot launch one).
extern "C" int avir_fused_ring_max_clusters(int cluster, int ring_rows, int* count) {
  const size_t bytes = smem_bytes(ring_rows);
  *count = 0;
  if (cluster < 1 || cluster > kMaxCluster || bytes > static_cast<size_t>(kMaxSmem)) return 0;
  cudaError_t e = set_attributes(cluster, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(dim3(cluster, 1, 1), bytes, nullptr, &attr, cluster);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(count, fused_ring_vh, &cfg));
}

extern "C" int avir_fused_ring(
    const void* x, void* out, void* stream,
    int rows_in, int lanes_in, int pad_top, int rows_out, int lanes_out, int tc,
    const void* v1, const void* v0, const void* offs_v,
    int tv, int wv,
    const void* h1p, const void* h0p,
    int n_ch, int win_c,
    const void* k_range, int n_slices,
    int cluster, int n_clusters,
    const void* chunk_of, const void* seg_of, const void* off_of,
    const void* slices, const void* part_ptr, int parts,
    int ring_rows,
    int sh, float rec,
    int alpha_lane, float in_gamma_mult, float out_gamma_mult) {
  const size_t bytes = smem_bytes(ring_rows);
  if (ring_rows % 32 != 0 || ring_rows <= 0 || cluster < 1 || cluster > kMaxCluster ||
      bytes > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = static_cast<const uint8_t*>(x);
  a.rows_in = rows_in;
  a.lanes_in = lanes_in;
  a.pad_top = pad_top;
  a.vec4 = lanes_in % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  a.out = static_cast<uint8_t*>(out);
  a.rows_out = rows_out;
  a.lanes_out = lanes_out;
  a.tc = tc;
  a.v1 = static_cast<const int8_t*>(v1);
  a.v0 = static_cast<const int8_t*>(v0);
  a.offs_v = static_cast<const int32_t*>(offs_v);
  a.tv = tv;
  a.wv = wv;
  a.h1p = static_cast<const uint32_t*>(h1p);
  a.h0p = static_cast<const uint32_t*>(h0p);
  a.n_ch = n_ch;
  a.win_c = win_c;
  a.k_range = static_cast<const int32_t*>(k_range);
  a.n_slices = n_slices;
  a.cluster = cluster;
  a.chunk_of = static_cast<const int32_t*>(chunk_of);
  a.seg_of = static_cast<const int32_t*>(seg_of);
  a.off_of = static_cast<const int32_t*>(off_of);
  a.slices = static_cast<const int4*>(slices);
  a.part_ptr = static_cast<const int32_t*>(part_ptr);
  a.ring_rows = ring_rows;
  a.sh = sh;
  a.rec = rec;
  a.epi.alpha_lane = alpha_lane;
  a.epi.in_gamma_mult = in_gamma_mult;
  a.epi.out_gamma_mult = out_gamma_mult;
  a.epi.scale = 1.0f;
  a.epi.even = 0;
  a.epi.trunc_bits = 0;
  a.epi.tm = 1.0f;
  a.epi.out_max = 255.0f;
  if (n_clusters <= 0 || parts <= 0) return 0;
  cudaError_t e = set_attributes(cluster, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(dim3(n_clusters * cluster, parts, 1), bytes,
                                        static_cast<cudaStream_t>(stream), &attr, cluster);
  e = cudaLaunchKernelEx(&cfg, fused_ring_vh, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
