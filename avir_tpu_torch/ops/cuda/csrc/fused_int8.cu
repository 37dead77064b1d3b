// Fused two-pass int8 resize (K1, int8 mode) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// avir_tpu/ops/pallas/fused_kernel.py: apply_fused_pallas -> _kernel ->
// _int8_passes -> _finish, in its int8 mode, with its epilogue options:
// the biased or round-half-even rounding, LANCIR's output ``scale``, and
// the sRGB gamma stages (the u8 linearization quantized to 13-bit linear
// light, _linear_to_srgb, the C=4 alpha bypass).  One launch computes the
// whole separable resize [rows_in, lanes_in] u8 -> [rows_out, lanes_out]
// u8 from radix-128 two-limb s8 taps; the 15-bit inter-pass intermediate
// lives only in shared memory.
//
// Arithmetic (bit-exact with the TPU kernel): every product and sum
// before the float recombination is an exact s32 integer, and each
// output's recombination uses only that output's full sums, so the
// result does not depend on the tiling.  Float steps use the _rn
// intrinsics so that no FMA contraction can move a rounding
// (k1_common.cuh).
//
//   input (the template parameter IN)
//     kU8       no gamma: xs = s8(x ^ 0x80) = x - 128; reads past the edge
//               see 0 (so -128, as in the plain version).
//     kGamma    gamma, the in-kernel route: xq = gamma_in_q13(x) (13-bit
//               linear light; the alpha lane only scaled), split into s8
//               limbs xq1 = (xq + 64) >> 7, xq0 = xq - 128*xq1; reads past
//               the edge see x = 0, whose xq is 0.  Each block first fills
//               a shared table of xq for all 256 u8 values (512 with an
//               alpha lane, k1::fill_q13_table) and splits each entry in
//               place into its limb pair; every staged element is one read
//               of that table, and byte permutes gather four entries' hi
//               (lo) limbs into a word of the hi (lo) plane.
//     kPlanes   gamma from limb planes (_kernel's x_lo input): xq1 and xq0
//               read from the two s8 planes of the prologue kernel K5
//               (gamma_prologue.cu), which computed them from the same
//               table.
//   vh (downsize), per output row r and lane l:
//     fq  = 128*sum q1v*xs + sum q0v*xs + v_comp[r]   (v_comp: row sums)
//         gamma: 2^14*sum q1v*xq1 + 2^7*(sum q1v*xq0 + sum q0v*xq1)
//     x15 = (fq + 2^(sh-1)) >> sh ; x1 = (x15+64)>>7 ; x0 = x15 - 128*x1
//     pa  = sum x1*h1 ; pb = sum x0*h1 + sum x1*h0     (over the chunk)
//   hv (upsize):
//     fq  = 128*sum xs*h1 + sum xs*h0 + h_comp[l]      (h_comp: col sums)
//         gamma: 2^14*sum xq1*h1 + 2^7*(sum xq0*h1 + sum xq1*h0)
//     x15, x1, x0 as above
//     pa  = sum q1v*x1 ; pb = sum q1v*x0 + sum q0v*x1
//   epilogue    acc = (f32(pa)*16384 + f32(pb)*128) * rec  (rec = 2^-k)
//               gamma: acc = linear_to_srgb(acc) * out_gamma_mult
//               acc *= scale (when != 1); out = u8(clamp(rint(acc)) or
//               clamp(floor(acc + 0.5)), 0, 255)
//
// Both passes run on the int8 tensor cores, mma.sync.aligned.m16n8k32.row
// .col.s32.s8.s8.s32 from shared memory, in every input mode.  Fragments
// (g = lane / 4, t = lane % 4): A (16 x 32 bytes, row-major) comes from one
// ldmatrix.x4 (b16, no .trans: each 8x8 b16 matrix is 8 rows of 16 bytes,
// and thread l gets bytes 4t..4t+3 of row g), with row (l & 15) and byte
// column (l >> 4) * 16 as the address rule; the same instruction on a
// [N][K] tile gives the B fragments of two n8 tiles ({r0, r2}: rows 0-7,
// {r1, r3}: rows 8-15).  A B operand stored as [K/4][N] words (4
// contraction bytes a word) gives b0 = word (t, g) and b1 = word (t + 4, g)
// by plain 32-bit loads; those rows are padded to 136 words so that the 32
// threads hit 32 banks.  The two limb products of a pass share their B
// fragments: [q1; q0] against one image fragment, [x1; x0] against h1
// (plus x1 h0) in vh, and [x1; x0] against q1 (plus x1 q0) in hv.  With
// gamma the first pass makes a third product (m0 += q1 xq0, f0 += h1 xq0)
// and requantizes fq = 2^14 m1 + 2^7 m0 with no comp sums.  No .satfinite:
// a wrapped partial sum still gives the exact total, which int8_feasible
// keeps inside s32; with gamma it bounds 2^14 * 64 q_abs1 + 2^7 * 64
// (q_abs1 + q_abs0) + 2^26 below 2^31 over the first pass's taps, so no
// partial sum of m1 / f1 or m0 / f0 and no fq wraps (the second pass's
// sums may wrap, as without gamma).
//
//   vh (fused_int8_vh_mma<IN>): a block owns 32 output rows (a slice of
//   one V block) and one 128-lane output chunk; 8 warps, warp (wm, wn)
//   owns rows 16 wm.. and lanes 32 wn.. of both passes.  The chunk's
//   nonzero lane range (h_range, 32-aligned) is cut into segments of 128
//   lanes.  Per segment: the first pass over the slice's nonzero V-tap rows
//   (slice_range, here the same as k_range), 64 a step (two MMA depths): V
//   taps [32][64] (A) and the image tile [64][<= 128] raw, then the tile
//   stored as B words of 4 rows ([16][128] words a plane) after 4 x 4 byte
//   transposes by byte permutes: kU8 one plane ^ 0x80; kPlanes both planes'
//   words as read; kGamma each byte's limb pair read from the table and the
//   transposed hi and lo words assembled from those entries by the byte
//   permutes (the global read stays one u8 plane; the two planes fill the
//   buffer kPlanes lays out as [2][16][136] words).  The segment's last
//   such step requantizes the sums into s8 limb planes x1 / x0 in shared
//   memory (row-major, A of the second pass); then the second pass, 64
//   lanes a step: h1p / h0p words [16][128] (B).  All steps of all segments
//   form one sequence on a ring of kStages = 4 stages in shared memory (in
//   every input mode), each one step's operands as they land: a step's
//   copies are one cp.async group (16 bytes a copy, zero fill past the
//   edge; 4 bytes where image rows are 4- but not 16-byte aligned; where
//   they are neither, its image words are loaded by bytes and stored, four
//   in flight a thread), issued at the end of the step kStages - 1 before
//   it, and a step starts with cp.async.wait_group kStages - 2 and one
//   barrier (a first-pass step one more, after its transposes, which read
//   the landed tile: no image word is held in registers across the MMAs).
//   The staging loops cover the whole tile, a fixed number of copies a
//   thread, so that their indices are shifts and masks: integer divisions
//   by the step's extent had made index arithmetic most of a step.  vh
//   runs 32 rows: a 64-row vh tiling measured 47-65% slower at both 8K
//   downsizes.
//   hv (fused_int8_hv_mma<R, IN>): computed transposed, so that no byte
//   needs transposing: F^T[n][k] = sum_m H^T[n][m] X^T[m][k], whose B
//   fragment is 4 lanes of one image row, and out^T[n][r] = sum_k XT[n][k]
//   V[r][k], whose A is the intermediate as [lane][row] bytes and whose B
//   is the V taps as stored.  A tile is R output rows of one chunk; warp w
//   owns lanes 16 w..16 w + 15.  A block walks a run of consecutive tiles
//   of the chunk-major order (fused_kernel.py:hv_blocks, hv_runs: as many
//   blocks as stay resident, the runs cut at equal shares of the tiles'
//   estimated cycles; one tile a block where the tiles fit the card at
//   once), so that consecutive tiles share their lane taps H^T ([128][<=
//   128] bytes, staged again only where the run reaches the next chunk).
//   Per window of the tile's nonzero V-tap rows (one but where a range is
//   taller than kw: 256 rows, an hv order on a steep row downsize, R = 32),
//   phase 1: for each 32-row group, the first pass over the chunk's
//   nonzero lane range (the image tile [32][<= 128] copied raw by cp.async,
//   zero fill past the edge, the next step's tile in flight during this
//   step's MMAs; the lane taps per 128-lane piece where the range is
//   wider), requantized into the shared intermediate XT [128][kw]; phase 2:
//   per 32-row sub-tile, V taps by cp.async (double-buffered), the second
//   pass over the sub-tile's own nonzero range (k_range), the epilogue.  A
//   window's first copies (its lane taps where st holds another chunk's,
//   its first image tile, its first sub-tile's V taps) are issued during
//   the last sub-tile of the window before it in the run, so that only a
//   run's first window waits for copies it issued itself.  The staging
//   loops cover a whole tile, a fixed number of copies a thread (shifts
//   and masks, as vh's).  Each pass's sums live in its own steps (R >= 64;
//   R = 32 carries the second pass's across windows), so that registers
//   hold one pass's accumulators at a time.  The epilogue (R >= 64)
//   finishes a sub-tile's outputs into a free image buffer and writes them
//   out 16 lanes a thread, where one byte a thread a row took 36-38% of the
//   one-tile kernel's cycles (k1_phases.py).  kU8 flips each fragment
//   register (^ 0x80808080); kPlanes stages both planes' tiles; kGamma
//   stages the u8 tile and, once it has landed, converts it in shared
//   memory into the two limb planes (one table read a byte, 16 lanes of a
//   row a thread) and one barrier more before the MMAs: every warp reads
//   every byte of the tile, so a conversion in the fragment registers
//   would run 8 times a byte.
//   hv's slice height R (32, 64 or 128) is a template parameter that the
//   host chooses from the operators (fused_kernel.py:slice_rows): the
//   tallest whose grid keeps two blocks per SM of the card, whose slices'
//   nonzero ranges fit the intermediate and (gamma) whose shared memory
//   lets two blocks share an SM (a taller slice recomputes fewer window
//   rows: the first pass reads each input byte 7.9 / 5.9 / 3.9 times at 32
//   / 64 / 128 rows at 1920x1080 -> 3840x2160).
//
// What bounds them.  The image read once plus the output written once: at
// 7680x4320 -> 1920x1080 0.0317 ms (bytes at the H100 SXM data sheet's
// 3.35 TB/s), at 1920x1080 -> 3840x2160 0.00935 ms; with gamma the float32
// gamma stages (counted as 15 operations an input element and 16 an
// output at 67 TFLOP/s: 0.024 / 0.0073 ms) stay below both, and kPlanes
// reads two planes, 0.061 / 0.0112 ms.  The MMAs issue 5-14x the band MACs
// (dense tap blocks over the nonzero ranges; gamma one product more a
// first-pass step), tens of microseconds at the data sheet's int8
// tensor-core rate.  Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py --kernel-times, k1_phases.py, PERF.md): vh at 8K -> 1080p
// 0.234-0.249 ms without gamma (7.4-7.9x the bytes bound; the one-step
// pipeline before the ring 0.343-0.377 in the same calls), 0.198-0.228
// with LANCIR's round-half-even and scale, kPlanes 0.297-0.345, kGamma
// 0.358-0.421 (before: 0.298-0.320, 0.452-0.471, 0.448-0.518); hv at 1080p
// -> 4K without gamma 0.119-0.129 a frame of 60 back to back (13-14x; the
// one-tile block before: 0.141-0.148), kPlanes 0.218-0.251, kGamma
// 0.239-0.250 at 128-row slices (before: 0.250-0.255, 0.270-0.288).  An hv
// tile takes ~34,000 cycles of thread 0 (the one-tile block: ~44,500): a
// first-pass step ~2,600, a second-pass sub-tile ~5,200, of which the
// epilogue ~2,500-2,800 (k1_phases.py --order hv).  A vh step takes
// 2,000-2,500 cycles of thread 0 at two blocks an
// SM (k1_phases.py, 5184x3456 -> 1920x1280): MMAs and their 32-bit
// B-fragment loads 35-45%, the transposes about 20% of a first-pass step,
// issuing the copies 25-30%, the group wait and barriers 17-23%; none
// dominates, so shared-memory traffic and instruction issue bound it
// together.  The first pass reads each input byte about twice at 8K, 3.9
// times at 2x upsizes at 128-row slices (chip_smoke.py prints the factor).
// Shared memory of vh (kStages = 4): kU8 87,552 bytes, kPlanes 112,640,
// kGamma 98,304, each within two blocks an SM.  Registers and spills
// (ptxas for sm_90a, printed by chip_smoke.py): vh kU8 120 registers,
// kPlanes 122, kGamma 128 with 4 bytes spilled; hv 128 registers, spilling
// at 128 and 64 rows 0 bytes (kPlanes), 40 stored and 80 loaded (kU8) or
// 60 and 100 (kGamma), at 32 rows (both passes' sums live) 72-272.
//
// Bit-equality.  Every product and sum before the recombination is an
// exact s32 integer (tensor-core s8 x s8 -> s32, wrapping), the
// requantization and the epilogue are the k1:: functions, and each output
// is recombined from its own full sums, so the bits do not depend on the
// tiling or the input mode: the kernels equal the plain version, and the
// in-kernel gamma route equals the limb-plane route and K6.

#include <cstdint>
#include <cuda_runtime.h>

#include "k1_common.cuh"
#include "mma_s8.cuh"

namespace {

using namespace mma_s8;

constexpr int kThreads = 256;
constexpr int kRows = 32;    // vh output rows per block
constexpr int kLanes = 128;  // output lanes per block (one chunk)
constexpr int kDepth = 32;   // contraction elements of one MMA step

// The first pass's input (the kernels' template parameter IN).
enum In : int {
  kU8 = 0,      // the u8 image, shifted to s8 (x ^ 0x80), with the comp sums
  kPlanes = 1,  // K5's two s8 limb planes of the linearized image (x, x_lo)
  kGamma = 2,   // the u8 image, linearized in the kernel from a shared table
};

// Bytes of the linearization table, q13[2][256] int32 (kGamma).
constexpr int kTableBytes = 2 * 256 * 4;

// Input planes read from global memory: both limb planes with kPlanes.
__host__ __device__ constexpr int loads(int in) { return in == kPlanes ? 2 : 1; }

struct Args {
  const uint8_t* x;        // the u8 image, or (kPlanes) the hi limb plane
  const uint8_t* x_lo;     // kPlanes: the lo limb plane
  int rows_in, lanes_in;   // extent of x (and x_lo)
  uint8_t* out;
  int rows_out, lanes_out;
  const int8_t* v1;        // [Bv, Tv, Wv]
  const int8_t* v0;
  const int32_t* v_comp;   // [Bv, Tv] (vh, kU8)
  const int32_t* offs_v;   // [Bv]
  int tv, wv;
  const uint32_t* h1p;     // [Bh, n_ch, win_c/4, 128] packed along win_c (vh)
  const uint32_t* h0p;
  const int32_t* h_comp;   // [Bh, n_ch, 128] (hv, kU8)
  const int32_t* offs_l;   // [Bh]
  const int32_t* rel;      // [n_ch]
  int n_ch, win_c, tc;
  const int32_t* k_range;  // [Bv, n_slices, 2] nonzero V-tap rows, 32-row slices (hv)
  int n_slices;
  const int32_t* slice_range;  // [Bv, n_slices_r, 2] the same over R-row slices
  int n_slices_r;
  const int32_t* h_range;  // [Bh, n_ch, 2] nonzero lane-tap rows, 32-aligned
  const int8_t* h1t;       // [Bh, n_ch, 128, win_c] lane taps transposed (hv)
  const int8_t* h0t;
  int kwin;                // hv: rows of the shared intermediate (<= 256)
  int bv;                  // hv: V blocks
  const int32_t* runs;     // hv: [gridDim.x + 1] each block's first tile
  bool vec4, vec16;        // image rows and windows 4- / 16-byte aligned
  int sh;                  // first-pass requantizing shift (>= 1)
  float rec;               // 2^-(x_shift + second-pass q_shift)
  k1::Epilogue epi;
};

template <bool GAMMA>
__device__ __forceinline__ uint8_t finish(const Args& a, int32_t pa, int32_t pb, int lane) {
  const float acc = k1::recombine(pa, pb, a.rec);
  return static_cast<uint8_t>(static_cast<int>(k1::finish_int<GAMMA>(a.epi, acc, lane)));
}

// kGamma's table: k1::fill_q13_table's 13-bit linear light of every u8
// value (row 1: the alpha lane's), each entry then split in place into its
// balanced s8 limbs q = 128 hi + lo, hi in byte 0 and lo in byte 1.
__device__ __forceinline__ void fill_limb_table(const k1::Epilogue& e, int32_t (*lt)[256]) {
  k1::fill_q13_table(e, lt);
  const int n = e.alpha_lane >= 0 ? 512 : 256;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int32_t q = lt[i >> 8][i & 255];
    const int32_t h = k1::limb_hi(q);
    lt[i >> 8][i & 255] = (h & 0xff) | ((q - 128 * h) & 0xff) << 8;
  }
  __syncthreads();
}

// Offsets into the limb table of byte i of a word whose first lane is l
// (row 1 for the alpha lane, as k1::q13_of).
__device__ __forceinline__ void table_rows(const Args& a, int l, int (&off)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) off[i] = k1::is_alpha(a.epi, l + i) ? 256 : 0;
}

// The table entries of the four bytes of image word w (a zero byte, as
// past the edge, reads xq = 0).
__device__ __forceinline__ void table_entries(const int32_t* lt, const int (&off)[4], uint32_t w,
                                              uint32_t (&t)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) t[i] = static_cast<uint32_t>(lt[off[i] + ((w >> (8 * i)) & 0xff)]);
}

// One limb of four table entries as a word, entry k in byte k: the hi
// limbs with kHi, the lo limbs with kLo.
constexpr uint32_t kHi = 0x0040, kLo = 0x0051;
__device__ __forceinline__ uint32_t limb_word(uint32_t t0, uint32_t t1, uint32_t t2, uint32_t t3,
                                              uint32_t sel) {
  return __byte_perm(__byte_perm(t0, t1, sel), __byte_perm(t2, t3, sel), 0x5410);
}

// ---------------------------------------------------------------------------
// Tensor-core kernels: building blocks (mma_s8.cuh) and the edges
// ---------------------------------------------------------------------------

// Output element (row tr of V block vb, lane cl of lane block hb).
template <bool GAMMA>
__device__ __forceinline__ void store1(const Args& a, int vb, int tr, int hb, int cl,
                                       int32_t pa, int32_t pb) {
  const int orow = vb * a.tv + tr, olane = hb * a.tc + cl;
  if (tr < a.tv && orow < a.rows_out && cl < a.tc && olane < a.lanes_out) {
    a.out[static_cast<size_t>(orow) * a.lanes_out + olane] = finish<GAMMA>(a, pa, pb, olane);
  }
}

// Word of 4 lanes l..l+3 of row r of the image (or of a limb plane, ``x``
// of the image's extent), zero past the edge.
__device__ __forceinline__ uint32_t load_word(const Args& a, int r, int l,
                                              const uint8_t* x = nullptr) {
  if (r >= a.rows_in) return 0u;
  const uint8_t* p = (x ? x : a.x) + static_cast<size_t>(r) * a.lanes_in + l;
  if (a.vec4) return l < a.lanes_in ? __ldg(reinterpret_cast<const uint32_t*>(p)) : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (l + e < a.lanes_in) v |= static_cast<uint32_t>(__ldg(p + e)) << (8 * e);
  }
  return v;
}

// ---------------------------------------------------------------------------
// vh on the tensor cores
// ---------------------------------------------------------------------------

// The vh kernel's tiles and its shared memory for input mode IN: a ring of
// kStages stages, each one step's operands as they land (a first-pass
// step: the V taps and the raw image tile; a second-pass step: the lane-tap
// words), then the image tile of the step being computed, transposed into
// B words, the intermediate's limbs and (kGamma) the limb table.
template <int IN>
struct VhMma {
  static constexpr int kSeg = kLanes;                // window lanes per segment
  static constexpr int kStep = 2 * kDepth;           // rows / lanes per step
  static constexpr int kWn = 4;                      // warps across lanes (2 x 4 warps)
  static constexpr int kTapLd = kStep + 16;          // V-tap row stride, bytes
  static constexpr int kXLd = kSeg + 8;              // B-word row stride, words
  static constexpr int kHLd = kLanes + 8;            // lane-tap row stride, words
  static constexpr int kW4 = kStep / 4;              // word rows of a step
  static constexpr int kILd = kSeg + 16;             // intermediate row stride, bytes
  static constexpr int kStages = 4;                  // every input mode: two blocks an SM
  static constexpr int kBPlanes = IN == kU8 ? 1 : 2;  // planes of B words
  static constexpr int kSv = 2 * kRows * kTapLd;     // a stage's V taps
  static constexpr int kRaw = kStep * kSeg;          // a stage's image tile, one plane
  static constexpr int kSh = 2 * kW4 * kHLd * 4;     // a stage's lane-tap words
  static constexpr int kStage = kSv + loads(IN) * kRaw > kSh ? kSv + loads(IN) * kRaw : kSh;
  static constexpr int kSx = kBPlanes * kW4 * kXLd * 4;
  static constexpr int kSi = 2 * kRows * kILd;
  static constexpr size_t kBytes =
      kStages * kStage + kSx + kSi + (IN == kGamma ? kTableBytes : 0);
  // 4 x 4-byte blocks of a step's image tile per thread.
  static constexpr int kBlocks = kW4 * (kSeg / 4) / kThreads;

  // Stage s: sv [2 limb][kRows][kTapLd] V taps and raw [loads(IN)][kStep]
  // [kSeg] the image rows as read (first pass), or sh [2 limb][kW4][kHLd]
  // lane-tap words (second pass).  Then sx [kBPlanes][kW4][kXLd] the
  // computed step's B words, si [2 limb][kRows][kILd] the intermediate's
  // limbs, [2][256] (kGamma) the limb table.
  __device__ static uint8_t* stage(uint8_t* sm, int s) { return sm + s * kStage; }
  __device__ static uint8_t* sv(uint8_t* sm, int s, int p, int r) {
    return stage(sm, s) + (p * kRows + r) * kTapLd;
  }
  __device__ static uint8_t* raw(uint8_t* sm, int s, int p, int r) {
    return stage(sm, s) + kSv + (p * kStep + r) * kSeg;
  }
  __device__ static uint32_t* sh(uint8_t* sm, int s) {
    return reinterpret_cast<uint32_t*>(stage(sm, s));
  }
  __device__ static uint32_t* sx(uint8_t* sm) {
    return reinterpret_cast<uint32_t*>(sm + kStages * kStage);
  }
  __device__ static uint8_t* si(uint8_t* sm, int p, int r) {
    return sm + kStages * kStage + kSx + (p * kRows + r) * kILd;
  }
  __device__ static int32_t (*table(uint8_t* sm))[256] {
    return reinterpret_cast<int32_t (*)[256]>(sm + kStages * kStage + kSx + kSi);
  }

  // The staging loops run over a step's whole tile, a fixed number of
  // 16-byte parts (or words) a thread, and skip the parts past its n rows
  // or w lanes: every index is a shift or a mask.

  // V taps of rows r0..r0+31 over k0..k0+n-1 (rows past the block: 0): one
  // part a thread.
  __device__ static void stage_v(const Args& a, uint8_t* sm, int s, int vb, int r0, int k0, int n) {
    static_assert(2 * kRows * (kStep / 16) == kThreads, "one part a thread");
    const int c = threadIdx.x;
    const int p = c / (kRows * kStep / 16), r = c / (kStep / 16) % kRows, part = c % (kStep / 16);
    if (16 * part >= n) return;
    const bool valid = r0 + r < a.tv;
    const size_t row = static_cast<size_t>(vb) * a.tv + (valid ? r0 + r : 0);
    cp16(sv(sm, s, p, r) + part * 16, (p ? a.v0 : a.v1) + row * a.wv + k0 + part * 16, valid);
  }

  // Image rows row..row+n-1, lanes lane..lane+w-1 (kPlanes: both limb
  // planes, x then x_lo), raw, zero past the edge: by 16-byte cp.async
  // where rows and windows are 16-byte aligned, by 4-byte cp.async where
  // they are 4-byte aligned (a rolled loop: unrolled, its addresses cost
  // the 16-byte path registers), else as words of byte loads, four in
  // flight at a time.
  __device__ static void stage_img(const Args& a, uint8_t* sm, int s, int row, int lane, int n,
                                   int w) {
    if (a.vec16) {
      constexpr int kPer = kSeg / 16;  // parts of a row
#pragma unroll
      for (int i = 0; i < loads(IN) * kStep * kPer / kThreads; ++i) {
        const int c = threadIdx.x + i * kThreads;
        const int p = c / (kStep * kPer), r = c / kPer % kStep, q = c % kPer, l = lane + 16 * q;
        if (r >= n || 16 * q >= w) continue;
        const bool valid = row + r < a.rows_in && l < a.lanes_in;
        const size_t off = valid ? static_cast<size_t>(row + r) * a.lanes_in + l : 0;
        cp16(raw(sm, s, p, r) + 16 * q, (p ? a.x_lo : a.x) + off, valid);
      }
      return;
    }
    constexpr int kPer = kSeg / 4;  // words of a row
    if (a.vec4) {
#pragma unroll 1
      for (int i = 0; i < loads(IN) * kStep * kPer / kThreads; ++i) {
        const int c = threadIdx.x + i * kThreads;
        const int p = c / (kStep * kPer), r = c / kPer % kStep, q = c % kPer, l = lane + 4 * q;
        if (r >= n || 4 * q >= w) continue;
        const bool valid = row + r < a.rows_in && l < a.lanes_in;
        const size_t off = valid ? static_cast<size_t>(row + r) * a.lanes_in + l : 0;
        cp4(raw(sm, s, p, r) + 4 * q, (p ? a.x_lo : a.x) + off, valid);
      }
      return;
    }
#pragma unroll 1
    for (int i0 = 0; i0 < loads(IN) * kStep * kPer / kThreads; i0 += 4) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = threadIdx.x + (i0 + i) * kThreads;
        const int p = c / (kStep * kPer), r = c / kPer % kStep, q = c % kPer;
        v[i] = r < n && 4 * q < w ? load_word(a, row + r, lane + 4 * q, p ? a.x_lo : a.x) : 0u;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = threadIdx.x + (i0 + i) * kThreads;
        const int p = c / (kStep * kPer), r = c / kPer % kStep, q = c % kPer;
        *reinterpret_cast<uint32_t*>(raw(sm, s, p, r) + 4 * q) = v[i];
      }
    }
  }

  // Lane-tap words of window lanes l0..l0+n-1 of chunk ``chunk``.
  __device__ static void stage_h(const Args& a, uint8_t* sm, int s, int chunk, int l0, int n) {
    uint32_t* d = sh(sm, s);
    constexpr int kPer = kLanes / 4;  // parts of a word row
#pragma unroll
    for (int i = 0; i < 2 * kW4 * kPer / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int p = c / (kW4 * kPer), row = c / kPer % kW4, part = c % kPer;
      if (4 * row >= n) continue;
      const size_t w = (static_cast<size_t>(chunk) * (a.win_c / 4) + l0 / 4 + row) * kLanes + part * 4;
      cp16(d + (p * kW4 + row) * kHLd + part * 4, (p ? a.h0p : a.h1p) + w, true);
    }
  }

  // Thread block q's 4 x 4 bytes: word row k4, lanes 4 l4..4 l4 + 3.
  __device__ static int blk_k4(int i) { return (threadIdx.x + i * kThreads) / (kSeg / 4); }
  __device__ static int blk_l4(int i) { return (threadIdx.x + i * kThreads) % (kSeg / 4); }

  // Stage s's image tile (lanes from ``lane``; the first n rows, w lanes)
  // transposed into sx as words of 4 rows (one word a lane): the image
  // shifted to s8 (x ^ 0x80); (kPlanes) the two s8 limb planes as they
  // are; (kGamma) the image's limb pairs looked up in the table, each
  // transposed word of a plane assembled from four entries by byte
  // permutes.
  __device__ static void transpose(const Args& a, uint8_t* sm, int s, int lane, int n, int w) {
    constexpr uint32_t kFlip = IN == kU8 ? 0x80808080u : 0u;
    int off[4] = {0, 0, 0, 0};  // kGamma: the same for every block (4 l4 lanes apart)
    if (IN == kGamma) table_rows(a, lane, off);
#pragma unroll
    for (int i = 0; i < kBlocks; ++i) {
      const int k4 = blk_k4(i), l4 = blk_l4(i);
      if (4 * k4 >= n || 4 * l4 >= w) continue;
      uint32_t* dst = sx(sm) + k4 * kXLd + 4 * l4;
      uint32_t x[loads(IN)][4];
#pragma unroll
      for (int p = 0; p < loads(IN); ++p) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(raw(sm, s, p, 4 * k4)) + l4;
#pragma unroll
        for (int e = 0; e < 4; ++e) x[p][e] = src[e * (kSeg / 4)];
      }
      if (IN == kGamma) {
        uint32_t t[4][4];  // [row][lane]
#pragma unroll
        for (int e = 0; e < 4; ++e) table_entries(&table(sm)[0][0], off, x[0][e], t[e]);
        uint4 hi, lo;
        hi.x = limb_word(t[0][0], t[1][0], t[2][0], t[3][0], kHi);
        hi.y = limb_word(t[0][1], t[1][1], t[2][1], t[3][1], kHi);
        hi.z = limb_word(t[0][2], t[1][2], t[2][2], t[3][2], kHi);
        hi.w = limb_word(t[0][3], t[1][3], t[2][3], t[3][3], kHi);
        lo.x = limb_word(t[0][0], t[1][0], t[2][0], t[3][0], kLo);
        lo.y = limb_word(t[0][1], t[1][1], t[2][1], t[3][1], kLo);
        lo.z = limb_word(t[0][2], t[1][2], t[2][2], t[3][2], kLo);
        lo.w = limb_word(t[0][3], t[1][3], t[2][3], t[3][3], kLo);
        *reinterpret_cast<uint4*>(dst) = hi;
        *reinterpret_cast<uint4*>(dst + kW4 * kXLd) = lo;
        continue;
      }
#pragma unroll
      for (int p = 0; p < loads(IN); ++p) {
        uint4 v = transpose4(x[p][0], x[p][1], x[p][2], x[p][3]);
        v.x ^= kFlip;
        v.y ^= kFlip;
        v.z ^= kFlip;
        v.w ^= kFlip;
        *reinterpret_cast<uint4*>(dst + p * kW4 * kXLd) = v;
      }
    }
  }
};

// One block: output rows r0..r0+31 of V block vb x the 128 lanes of chunk
// j of lane block hb.  The work is one sequence of steps of up to 64 rows
// or lanes (two 32-deep MMA steps): per lane segment, the first pass's
// steps over slice_range (V taps x image words into m1 / m0, which the
// segment's last such step requantizes into the intermediate limbs) and
// then the second pass's steps over the segment's lanes (limbs x lane taps
// into pa / pb).  Every step's operands come through the ring, one
// cp.async group a step, issued kStages - 1 steps ahead at the end of a
// step: while a step's MMAs run, the next kStages - 2 steps' copies are in
// flight; a first-pass step first transposes its landed image tile into B
// words (one barrier more).  The MMA loops are unrolled over the step's
// two 32-deep halves.  With gamma (IN kPlanes: K5's limb planes, the x_lo
// input; kGamma: the image, linearized as it is transposed) the first pass
// stages two limb planes, makes three products, m1 = q1 xq1 and m0 = q0
// xq1 + q1 xq0 (the first two share the B fragment of xq1), requantizes
// fq = 2^14 m1 + 2^7 m0, and the epilogue converts back to sRGB.
template <int IN>
__global__ void __launch_bounds__(kThreads, 2) fused_int8_vh_mma(const Args a) {
  using K = VhMma<IN>;
  constexpr int S = K::kStages;
  constexpr bool kLimbs = IN != kU8;  // gamma: two limb planes, three products
  extern __shared__ __align__(16) uint8_t sm[];

  const int chunk = blockIdx.x;
  const int hb = chunk / a.n_ch, j = chunk % a.n_ch;
  const int vb = blockIdx.y / a.n_slices_r, slice = blockIdx.y % a.n_slices_r;
  const int r0 = slice * kRows;
  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int wm = warp / K::kWn, wn = warp % K::kWn;
  const int arow = lid & 15, acol = (lid >> 4) * 16;  // ldmatrix address of this thread
  const int g = lid / 4, t = lid % 4;                 // fragment row / column group
  const int k_lo = a.slice_range[2 * blockIdx.y];
  const int k_hi = a.slice_range[2 * blockIdx.y + 1];
  const int h_lo = a.h_range[2 * chunk];
  const int h_hi = a.h_range[2 * chunk + 1];
  const int row0 = a.offs_v[vb] + k_lo;
  const int lane0 = a.offs_l[hb] + a.rel[j];
  const int kw = k_hi - k_lo;
  const int nv = (kw + K::kStep - 1) / K::kStep;  // first-pass steps per segment
  // No nonzero V tap or lane tap: the block's sums are 0.
  const bool work = nv > 0 && h_lo < h_hi;
  int32_t comp[2] = {0, 0};  // the -128 shift's row sums (no gamma)
#pragma unroll
  for (int h = 0; h < 2 && !kLimbs; ++h) {
    const int tr = r0 + 16 * wm + g + 8 * h;
    comp[h] = tr < a.tv ? a.v_comp[vb * a.tv + tr] : 0;
  }

  // Step (seg, i): first-pass step i < nv of the segment at window lane
  // seg, else its second-pass step i - nv.
  const auto advance = [&](int& seg, int& i) {
    const int w = min(K::kSeg, h_hi - seg);
    if (++i == nv + (w + K::kStep - 1) / K::kStep) {
      seg += K::kSeg;
      i = 0;
    }
  };
  // Step (seg, i)'s copies into stage s.
  const auto issue = [&](int seg, int i, int s) {
    const int w = min(K::kSeg, h_hi - seg);
    if (i < nv) {
      const int n = min(K::kStep, kw - i * K::kStep);
      K::stage_v(a, sm, s, vb, r0, k_lo + i * K::kStep, n);
      K::stage_img(a, sm, s, row0 + i * K::kStep, lane0 + seg, n, w);
    } else {
      const int l0 = (i - nv) * K::kStep;
      K::stage_h(a, sm, s, chunk, seg + l0, min(K::kStep, w - l0));
    }
  };
  int pseg = h_lo, pi = 0;  // the next step to issue
  if (work) {
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (pseg < h_hi) {
        issue(pseg, pi, s);
        advance(pseg, pi);
      }
      cp_commit();
    }
  }
  if (IN == kGamma) fill_limb_table(a.epi, K::table(sm));

  int32_t pa[4][4] = {}, pb[4][4] = {};
  if (work) {
    int32_t m1[4][4] = {}, m0[4][4] = {};
    for (int seg = h_lo, i = 0, s = 0; seg < h_hi; advance(seg, i), s = s + 1 == S ? 0 : s + 1) {
      // This step's copies landed (this thread's, then every thread's), and
      // every warp is done with the step before, whose stage this step
      // refills at its end.
      cp_wait<S - 2>();
      __syncthreads();
      const int w = min(K::kSeg, h_hi - seg);  // a multiple of 32
      if (i < nv) {
        // ---- first (vertical) pass step: warps past the segment idle ----
        const int n = min(K::kStep, kw - i * K::kStep);
        K::transpose(a, sm, s, lane0 + seg, n, w);
        __syncthreads();
        if (32 * wn < w) {
          const uint32_t* x = K::sx(sm);
#pragma unroll
          for (int kk = 0; kk < K::kStep; kk += kDepth) {
            if (kk >= n) break;
            uint32_t q1[4], q0[4];
            ldsm(q1, K::sv(sm, s, 0, 16 * wm + arow) + kk + acol);
            ldsm(q0, K::sv(sm, s, 1, 16 * wm + arow) + kk + acol);
            const uint32_t* xk = x + kk / 4 * K::kXLd;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int col = 32 * wn + 8 * c + g;
              const uint32_t b0 = xk[t * K::kXLd + col], b1 = xk[(t + 4) * K::kXLd + col];
              mma8(m1[c], q1, b0, b1);
              mma8(m0[c], q0, b0, b1);
              if (kLimbs) {
                const uint32_t* xl = xk + K::kW4 * K::kXLd;  // the lo plane
                mma8(m0[c], q1, xl[t * K::kXLd + col], xl[(t + 4) * K::kXLd + col]);
              }
            }
          }
          if (i == nv - 1) {
            // The segment's intermediate, requantized into shared memory
            // (the second-pass steps before it ended at a barrier).
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int col = 32 * wn + 8 * c + 2 * t;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = 16 * wm + g + 8 * h;
                // No gamma: fq = 128 m1 + m0 + v_comp; gamma: 2^14 m1 + 2^7 m0.
                const int32_t s1 = kLimbs ? 16384 : 128, s0 = kLimbs ? 128 : 1;
                limbs2(m1[c][2 * h] * s1 + m0[c][2 * h] * s0 + comp[h],
                       m1[c][2 * h + 1] * s1 + m0[c][2 * h + 1] * s0 + comp[h], a.sh,
                       K::si(sm, 0, r) + col, K::si(sm, 1, r) + col);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  m1[c][2 * h + e] = 0;
                  m0[c][2 * h + e] = 0;
                }
              }
            }
          }
        }
      } else {
        // ---- second (horizontal) pass step ---------------------------
        const int l0 = (i - nv) * K::kStep;
        const int n = min(K::kStep, w - l0);
#pragma unroll
        for (int kk = 0; kk < K::kStep; kk += kDepth) {
          if (kk >= n) break;
          uint32_t x1[4], x0[4];
          ldsm(x1, K::si(sm, 0, 16 * wm + arow) + l0 + kk + acol);
          ldsm(x0, K::si(sm, 1, 16 * wm + arow) + l0 + kk + acol);
          const uint32_t* h1 = K::sh(sm, s) + kk / 4 * K::kHLd;
          const uint32_t* h0 = h1 + K::kW4 * K::kHLd;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = 32 * wn + 8 * c + g;
            const uint32_t b10 = h1[t * K::kHLd + col], b11 = h1[(t + 4) * K::kHLd + col];
            const uint32_t b00 = h0[t * K::kHLd + col], b01 = h0[(t + 4) * K::kHLd + col];
            mma8(pa[c], x1, b10, b11);
            mma8(pb[c], x0, b10, b11);
            mma8(pb[c], x1, b00, b01);
          }
        }
      }
      // The step kStages - 1 ahead, into the stage of the step before:
      // issued after this step's MMAs, so that its copies do not queue
      // ahead of this step's shared-memory reads.
      if (pseg < h_hi) {
        issue(pseg, pi, s == 0 ? S - 1 : s - 1);
        advance(pseg, pi);
      }
      cp_commit();
    }
  }

  // ---- epilogue: accumulator (row g (+8), lanes 2t, 2t+1) -> output ---
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int tr = r0 + 16 * wm + g + 8 * h;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        store1<kLimbs>(a, vb, tr, hb, j * kLanes + 32 * wn + 8 * c + 2 * t + e,
                       pa[c][2 * h + e], pb[c][2 * h + e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// hv on the tensor cores (computed transposed)
// ---------------------------------------------------------------------------

constexpr int kPiece = 128;          // window lanes of lane taps staged at once
constexpr int kPieceLd = kPiece + 16;  // their row stride, bytes (also the image tile's)
constexpr int kHvSt = 2 * kLanes * kPieceLd;  // lane taps H^T, both limbs
constexpr int kHvSx = 2 * 32 * kPieceLd;      // image tiles of one plane, two buffers
constexpr int kHvMaxWin = 256;                // rows of the intermediate at most

// Shared memory of the hv kernel for an intermediate of kwin rows,
// ``planes`` planes of image tiles (1: the u8 image; 2: K5's limb planes,
// or the u8 image and its limb planes with the in-kernel gamma) and, with
// ``table``, the linearization table:
//   st [2 limb][128 n][kPieceLd]             lane taps H^T
//   sx [2 buf][planes][32 rows][kPieceLd]    image tiles (kU8, kPlanes: raw
//                                            bytes as staged; kGamma: the raw
//                                            u8 tiles [2 buf][32] then the
//                                            limb planes [2 limb][32])
//   xt [2 limb][128 n][kwin + 16]            intermediate limbs XT[n][k]
//   sv [2 buf][2 limb][32 rows][kwin + 16]   V taps of a sub-tile
//   [2][256] int32                           the limb table (kGamma)
// (fused_kernel.py:hv_smem_bytes mirrors it for the host's choice of R
// and of the blocks; avir_int8_mma_smem_bytes exports it for the card test
// that holds the two equal).
__host__ __device__ constexpr size_t hv_mma_smem_bytes(int kwin, int planes, bool table) {
  return kHvSt + static_cast<size_t>(planes) * kHvSx + static_cast<size_t>(6) * 64 * (kwin + 16) +
         (table ? kTableBytes : 0);
}

template <int IN>
struct HvMma {
  static constexpr int kTilePlanes = IN == kU8 ? 1 : 2;  // hv_mma_smem_bytes' planes
  static constexpr int kStaged = IN == kPlanes ? 2 : 1;   // planes staged by stage_img
  static constexpr int kSx = kTilePlanes * kHvSx;
  __device__ static uint8_t* st(uint8_t* sm, int p, int n) { return sm + (p * kLanes + n) * kPieceLd; }
  // Where stage_img puts plane p's row r of buffer b.
  __device__ static uint8_t* sx(uint8_t* sm, int b, int p, int r) {
    return sm + kHvSt + ((b * kStaged + p) * 32 + r) * kPieceLd;
  }
  // Where the MMAs read plane p's row r of the step in buffer b: kGamma's
  // limb planes (one buffer, after the raw tiles), else the staged tile.
  __device__ static uint8_t* xin(uint8_t* sm, int b, int p, int r) {
    return IN == kGamma ? sm + kHvSt + ((2 + p) * 32 + r) * kPieceLd : sx(sm, b, p, r);
  }
  __device__ static uint8_t* xt(uint8_t* sm, int kld, int p, int n) {
    return sm + kHvSt + kSx + (p * kLanes + n) * kld;
  }
  __device__ static uint8_t* sv(uint8_t* sm, int kld, int b, int p, int r) {
    return sm + kHvSt + kSx + 2 * kLanes * kld + ((b * 2 + p) * 32 + r) * kld;
  }
  __device__ static int32_t (*table(uint8_t* sm, int kld))[256] {
    return reinterpret_cast<int32_t (*)[256]>(sm + kHvSt + kSx + 6 * 64 * kld);
  }

  // The staging loops run over a whole tile, a fixed number of 16-byte
  // parts (or words) a thread, and skip the parts past its mw lanes or n
  // rows: every index is a shift or a mask.

  // kGamma: the raw tile of buffer b (lanes lane..lane+mw-1) turned into
  // the two limb planes by the limb table, 16 lanes of a row a thread.
  __device__ static void convert(const Args& a, uint8_t* sm, int kld, int b, int lane, int mw) {
    constexpr int kPer = kPiece / 16;  // parts of a row
    static_assert(32 * kPer == kThreads, "one part a thread");
    const int r = threadIdx.x / kPer, q = threadIdx.x % kPer;
    if (16 * q >= mw) return;
    const int32_t* lt = &table(sm, kld)[0][0];
    int off[4];  // the same for every word (4 lanes apart)
    table_rows(a, lane, off);
    const uint4 w = *reinterpret_cast<const uint4*>(sx(sm, b, 0, r) + 16 * q);
    const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t t[4];
      table_entries(lt, off, wv[e], t);
      hi[e] = limb_word(t[0], t[1], t[2], t[3], kHi);
      lo[e] = limb_word(t[0], t[1], t[2], t[3], kLo);
    }
    *reinterpret_cast<uint4*>(xin(sm, b, 0, r) + 16 * q) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(xin(sm, b, 1, r) + 16 * q) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }

  // Lane taps H^T of window lanes m0..m0+mw-1 of chunk ``chunk``: eight
  // parts a thread.
  __device__ static void stage_taps(const Args& a, uint8_t* sm, int chunk, int m0, int mw) {
    constexpr int kPer = kPiece / 16;  // parts of a row
#pragma unroll
    for (int i = 0; i < 2 * kLanes * kPer / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int p = c / (kLanes * kPer), n = c / kPer % kLanes, part = c % kPer;
      if (16 * part >= mw) continue;
      const size_t off = (static_cast<size_t>(chunk) * kLanes + n) * a.win_c + m0 + 16 * part;
      cp16(st(sm, p, n) + 16 * part, (p ? a.h0t : a.h1t) + off, true);
    }
  }

  // Image rows row..row+31, lanes lane..lane+mw-1 (kPlanes: both limb
  // planes, x then x_lo), raw, zero past the edge: by 16-byte cp.async
  // where rows and windows are 16-byte aligned, by 4-byte cp.async where
  // they are 4-byte aligned, else as words of byte loads, four in flight
  // at a time (as the vh kernel's).
  __device__ static void stage_img(const Args& a, uint8_t* sm, int b, int row, int lane, int mw) {
    if (a.vec16) {
      constexpr int kPer = kPiece / 16;  // parts of a row
#pragma unroll
      for (int i = 0; i < kStaged * 32 * kPer / kThreads; ++i) {
        const int c = threadIdx.x + i * kThreads;
        const int p = c / (32 * kPer), r = c / kPer % 32, q = c % kPer, l = lane + 16 * q;
        if (16 * q >= mw) continue;
        const bool valid = row + r < a.rows_in && l < a.lanes_in;
        const size_t off = valid ? static_cast<size_t>(row + r) * a.lanes_in + l : 0;
        cp16(sx(sm, b, p, r) + 16 * q, (p ? a.x_lo : a.x) + off, valid);
      }
      return;
    }
    constexpr int kPer = kPiece / 4;  // words of a row
    if (a.vec4) {
#pragma unroll 1
      for (int i = 0; i < kStaged * 32 * kPer / kThreads; ++i) {
        const int c = threadIdx.x + i * kThreads;
        const int p = c / (32 * kPer), r = c / kPer % 32, q = c % kPer, l = lane + 4 * q;
        if (4 * q >= mw) continue;
        const bool valid = row + r < a.rows_in && l < a.lanes_in;
        const size_t off = valid ? static_cast<size_t>(row + r) * a.lanes_in + l : 0;
        cp4(sx(sm, b, p, r) + 4 * q, (p ? a.x_lo : a.x) + off, valid);
      }
      return;
    }
#pragma unroll 1
    for (int i0 = 0; i0 < kStaged * 32 * kPer / kThreads; i0 += 4) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = threadIdx.x + (i0 + i) * kThreads;
        const int p = c / (32 * kPer), r = c / kPer % 32, q = c % kPer;
        v[i] = 4 * q < mw ? load_word(a, row + r, lane + 4 * q, p ? a.x_lo : a.x) : 0u;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = threadIdx.x + (i0 + i) * kThreads;
        const int p = c / (32 * kPer), r = c / kPer % 32, q = c % kPer;
        *reinterpret_cast<uint32_t*>(sx(sm, b, p, r) + 4 * q) = v[i];
      }
    }
  }

  // V taps of rows r0..r0+31 over window rows lo..hi-1 (rows past the
  // block: 0): up to four parts a thread.
  __device__ static void stage_v(const Args& a, uint8_t* sm, int kld, int b, int vb, int r0,
                                 int lo, int hi) {
    constexpr int kPer = kHvMaxWin / 16;  // parts of a row at most
#pragma unroll
    for (int i = 0; i < 2 * 32 * kPer / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int p = c / (32 * kPer), r = c / kPer % 32, part = c % kPer;
      if (16 * part >= hi - lo) continue;
      const bool valid = r0 + r < a.tv;
      const size_t row = static_cast<size_t>(vb) * a.tv + (valid ? r0 + r : 0);
      cp16(sv(sm, kld, b, p, r) + 16 * part, (p ? a.v0 : a.v1) + row * a.wv + lo + 16 * part,
           valid);
    }
  }
};

// A finished [32 rows][128 lanes] output tile ``ot`` (row stride
// kPieceLd) written out at rows tr0.. of V block vb and lanes cl0.. of lane
// block hb, 16 lanes a thread: one 16-byte store where all 16 are in
// range and aligned, else store1's bounds lane by lane.
__device__ __forceinline__ void store_rows(const Args& a, const uint8_t* ot, int vb, int tr0,
                                           int hb, int cl0) {
  static_assert(32 * (kLanes / 16) == kThreads, "16 lanes a thread");
  const int r = threadIdx.x / (kLanes / 16), p = threadIdx.x % (kLanes / 16);
  const int tr = tr0 + r, orow = vb * a.tv + tr, cl = cl0 + 16 * p, olane = hb * a.tc + cl;
  if (tr >= a.tv || orow >= a.rows_out) return;
  const uint8_t* src = ot + r * kPieceLd + 16 * p;
  uint8_t* dst = a.out + static_cast<size_t>(orow) * a.lanes_out + olane;
  if (cl + 16 <= a.tc && olane + 16 <= a.lanes_out && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    return;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    if (cl + e < a.tc && olane + e < a.lanes_out) dst[e] = src[e];
  }
}

// Tile f of the chunk-major order of (chunk, slice) pairs: the chunk (j
// of lane block hb), the slice (of V block vb), the slice's nonzero V-tap
// rows, the chunk's nonzero lane range and the image row and lane they
// start at.
struct HvTile {
  int chunk, hb, j, vb, slice;
  int kb_lo, kb_hi, h_lo, hw;
  int row0, lane0;
};
__device__ __forceinline__ HvTile hv_tile(const Args& a, int f) {
  HvTile T;
  const int n_y = a.bv * a.n_slices_r;
  T.chunk = f / n_y;
  const int y = f - T.chunk * n_y;
  T.hb = T.chunk / a.n_ch;
  T.j = T.chunk - T.hb * a.n_ch;
  T.vb = y / a.n_slices_r;
  T.slice = y - T.vb * a.n_slices_r;
  T.kb_lo = a.slice_range[2 * y];
  T.kb_hi = a.slice_range[2 * y + 1];
  T.h_lo = a.h_range[2 * T.chunk];
  T.hw = a.h_range[2 * T.chunk + 1] - T.h_lo;
  T.row0 = a.offs_v[T.vb];
  T.lane0 = a.offs_l[T.hb] + a.rel[T.j] + T.h_lo;
  return T;
}

// One block walks a run of tiles: the host's runs of the chunk-major order
// of (chunk, slice) pairs (fused_kernel.py:hv_runs, cut at equal shares
// of the tiles' estimated cycles), so that consecutive tiles of a run
// share a chunk and its lane taps.  A tile is output rows r0..r0+R-1 of V
// block vb x the 128 lanes of chunk j of lane block hb; warp w owns lanes
// 16 w..16 w + 15 of every product.
// Per window of at most kwin rows of the tile's nonzero V-tap range
// (several only with R = 32): phase 1 fills the intermediate XT[lane]
// [window row] (first pass per 32-row group, over the chunk's nonzero lane
// range in pieces of 128, the next step's image tile in flight), phase 2
// runs the second pass per 32-row sub-tile over its own nonzero range
// (k_range), the next sub-tile's V taps in flight, and stores it after the
// last window.  A window's first copies (its lane taps where st holds
// another chunk's, its first image tile, its first sub-tile's V taps) are
// issued during the last sub-tile of the window before it in the run, so
// that they fly during that sub-tile's MMAs and stores: only a run's first
// window waits for copies it issued itself.  The sums live in one pass
// (R >= 64; R = 32 carries the second pass's across windows), so that
// registers hold one pass's accumulators at a time; at R >= 64 a sub-tile's
// outputs are finished into image buffer 1 and written 16 lanes a thread
// (at R = 32 with gamma that path gave wrong bytes, so R = 32 keeps
// store1).  With gamma (IN
// kPlanes: K5's limb planes, the x_lo input, both staged raw; kGamma: the
// u8 image staged raw, then linearized once in shared memory into the two
// limb planes, one barrier later, while the next step's tile is in
// flight) phase 1 makes three products a fragment pair, f1 = h1 xq1 and
// f0 = h0 xq1 (one B fragment), then f0 += h1 xq0; it requantizes fq =
// 2^14 f1 + 2^7 f0 (no h_comp), and the epilogue converts back to sRGB.
template <int R, int IN>
__global__ void __launch_bounds__(kThreads, 2) fused_int8_hv_mma(const Args a) {
  using K = HvMma<IN>;
  constexpr bool kLimbs = IN != kU8;  // gamma: two limb planes, three products
  constexpr int kSub = R / 32;
  constexpr bool kCarry = R == 32;  // the host gives several windows only at R = 32
  extern __shared__ __align__(16) uint8_t sm[];

  const int warp = threadIdx.x / 32, lid = threadIdx.x % 32;
  const int arow = lid & 15, acol = (lid >> 4) * 16;
  const int g = lid / 4, t = lid % 4;
  const int kld = a.kwin + 16;
  const int f_lo = a.runs[blockIdx.x], f_hi = a.runs[blockIdx.x + 1];

  // Sub-tile sub's nonzero V-tap rows inside window [w0, w1) of tile T
  // (none: lo = hi = 0).
  const auto sub_range = [&](const HvTile& T, int w0, int w1, int sub, int& lo, int& hi) {
    const int s32 = T.slice * kSub + sub;
    lo = hi = 0;
    if (T.kb_lo < T.kb_hi && T.hw > 0 && s32 < a.n_slices) {
      const int* kr = a.k_range + 2 * (T.vb * a.n_slices + s32);
      lo = max(kr[0], w0);
      hi = min(kr[1], w1);
      if (hi <= lo) lo = hi = 0;
    }
  };
  // Window win of tile f's first copies: its lane taps where they are one
  // piece and st holds another chunk's, its first image tile (buffer 0)
  // and its first sub-tile's V taps (V buffer vbuf).
  int t_chunk = -1;  // the chunk whose lane taps (one piece) are in st
  const auto prefetch = [&](int f, int win, int vbuf) {
    const HvTile T = hv_tile(a, f);
    if (T.kb_lo >= T.kb_hi || T.hw <= 0) return;
    const int w0 = T.kb_lo + win * a.kwin, w1 = min(T.kb_hi, w0 + a.kwin);
    if (T.hw <= kPiece && T.chunk != t_chunk) {
      K::stage_taps(a, sm, T.chunk, T.h_lo, T.hw);
      t_chunk = T.chunk;
    }
    K::stage_img(a, sm, 0, T.row0 + w0, T.lane0, min(kPiece, T.hw));
    int lo, hi;
    sub_range(T, w0, w1, 0, lo, hi);
    K::stage_v(a, sm, kld, vbuf, T.vb, T.slice * R, lo, hi);
  };

  int vbuf = 0;  // the V buffer of the next sub-tile
  if (f_lo < f_hi) prefetch(f_lo, 0, vbuf);
  cp_commit();
  if (IN == kGamma) fill_limb_table(a.epi, K::table(sm, kld));

  int32_t pa_c[4][4] = {}, pb_c[4][4] = {};  // kCarry: the sums across windows
  for (int f = f_lo, win = 0; f < f_hi;) {
    const HvTile T = hv_tile(a, f);
    const bool work = T.kb_lo < T.kb_hi && T.hw > 0;
    const int n_win = work ? (T.kb_hi - T.kb_lo + a.kwin - 1) / a.kwin : 1;
    const int n_mc = (T.hw + kPiece - 1) / kPiece;  // lane-tap pieces
    const int r0 = T.slice * R;
    const int w0 = T.kb_lo + win * a.kwin, w1 = min(T.kb_hi, w0 + a.kwin);
    if (work) {
      // ---- phase 1: first (horizontal) pass into XT ------------------
      int32_t comp[2] = {0, 0};  // the -128 shift's column sums (no gamma)
#pragma unroll
      for (int h = 0; h < 2 && !kLimbs; ++h) {
        comp[h] = a.h_comp[T.chunk * kLanes + 16 * warp + g + 8 * h];
      }
      const int n_steps = (w1 - w0) / kDepth * n_mc;
      // The window's first copies (issued a sub-tile before) landed.
      cp_wait_all();
      __syncthreads();
      int32_t f1[4][4] = {}, f0[4][4] = {};
      for (int s = 0, b = 0; s < n_steps; ++s, b ^= 1) {
        const int gi = n_mc == 1 ? s : s / n_mc, ci = s - gi * n_mc;
        const int mw = min(kPiece, T.hw - ci * kPiece);
        // The taps of this piece and (kGamma) this step's limb planes; the
        // step before ended with a barrier, after its tile had landed.
        if (n_mc > 1) {
          K::stage_taps(a, sm, T.chunk, T.h_lo + ci * kPiece, mw);
          cp_commit();
        }
        if (IN == kGamma) K::convert(a, sm, kld, b, T.lane0 + ci * kPiece, mw);
        if (n_mc > 1 || IN == kGamma) {
          cp_wait_all();
          __syncthreads();
        }
        if (s + 1 < n_steps) {
          const int ng = n_mc == 1 ? s + 1 : (s + 1) / n_mc, nc = s + 1 - ng * n_mc;
          K::stage_img(a, sm, b ^ 1, T.row0 + w0 + ng * kDepth, T.lane0 + nc * kPiece,
                       min(kPiece, T.hw - nc * kPiece));
          cp_commit();
        }
        for (int kk = 0; kk < mw; kk += kDepth) {
          uint32_t h1[4], h0[4];
          ldsm(h1, K::st(sm, 0, 16 * warp + arow) + kk + acol);
          ldsm(h0, K::st(sm, 1, 16 * warp + arow) + kk + acol);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t xb[4];
            ldsm(xb, K::xin(sm, b, 0, 16 * half + arow) + kk + acol);
            if (!kLimbs) {
#pragma unroll
              for (int e = 0; e < 4; ++e) xb[e] ^= 0x80808080u;  // s8(x - 128)
            }
            mma8(f1[2 * half], h1, xb[0], xb[2]);
            mma8(f0[2 * half], h0, xb[0], xb[2]);
            mma8(f1[2 * half + 1], h1, xb[1], xb[3]);
            mma8(f0[2 * half + 1], h0, xb[1], xb[3]);
            if (kLimbs) {
              uint32_t xl[4];  // the lo plane
              ldsm(xl, K::xin(sm, b, 1, 16 * half + arow) + kk + acol);
              mma8(f0[2 * half], h1, xl[0], xl[2]);
              mma8(f0[2 * half + 1], h1, xl[1], xl[3]);
            }
          }
        }
        if (ci == n_mc - 1) {
          // Group gi done: F^T (lane g (+8), rows 2t, 2t+1 of tile jt)
          // requantized into XT's columns of those rows.  No gamma: fq =
          // 128 f1 + f0 + h_comp.  Gamma: fq = 2^14 f1 + 2^7 f0, where
          // int8_feasible's gamma bound (2^14 * 64 q_abs1 + 2^7 * 64
          // (q_abs1 + q_abs0) + 2^26 < 2^31 over the lane taps) keeps f1, f0
          // and fq inside s32; the second pass's sums may wrap, as without
          // gamma.
#pragma unroll
          for (int jt = 0; jt < 4; ++jt) {
            const int col = gi * kDepth + 8 * jt + 2 * t;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = 16 * warp + g + 8 * h;
              const int32_t s1 = kLimbs ? 16384 : 128, s0 = kLimbs ? 128 : 1;
              limbs2(f1[jt][2 * h] * s1 + f0[jt][2 * h] * s0 + comp[h],
                     f1[jt][2 * h + 1] * s1 + f0[jt][2 * h + 1] * s0 + comp[h], a.sh,
                     K::xt(sm, kld, 0, n) + col, K::xt(sm, kld, 1, n) + col);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                f1[jt][2 * h + e] = 0;
                f0[jt][2 * h + e] = 0;
              }
            }
          }
        }
        cp_wait_all();
        __syncthreads();
      }
      if (n_mc > 1) t_chunk = -1;  // st holds the last piece
    }
    // ---- phase 2: second (vertical) pass per 32-row sub-tile ---------
    // The window after this one in the run: this tile's next, or the next
    // tile's first.
    const int nf = win + 1 < n_win ? f : f + 1, nwin = win + 1 < n_win ? win + 1 : 0;
    int lo, hi;
    sub_range(T, w0, w1, 0, lo, hi);
#pragma unroll 1
    for (int sub = 0; sub < kSub; ++sub) {
      int nlo = 0, nhi = 0;
      if (sub + 1 < kSub) {
        sub_range(T, w0, w1, sub + 1, nlo, nhi);
        K::stage_v(a, sm, kld, vbuf ^ 1, T.vb, r0 + 32 * (sub + 1), nlo, nhi);
        cp_commit();
        cp_wait_one();
      } else if (nf < f_hi) {
        // The next window's first copies, in flight during this sub-tile.
        prefetch(nf, nwin, vbuf ^ 1);
        cp_commit();
        cp_wait_one();
      } else {
        cp_wait_all();
      }
      __syncthreads();
      int32_t pa_s[4][4] = {}, pb_s[4][4] = {};  // R >= 64: this sub-tile's sums
      int32_t (&pa)[4][4] = kCarry ? pa_c : pa_s;
      int32_t (&pb)[4][4] = kCarry ? pb_c : pb_s;
      for (int kk = lo; kk < hi; kk += kDepth) {
        uint32_t x1[4], x0[4];
        ldsm(x1, K::xt(sm, kld, 0, 16 * warp + arow) + kk - w0 + acol);
        ldsm(x0, K::xt(sm, kld, 1, 16 * warp + arow) + kk - w0 + acol);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t q1[4], q0[4];
          ldsm(q1, K::sv(sm, kld, vbuf, 0, 16 * half + arow) + kk - lo + acol);
          ldsm(q0, K::sv(sm, kld, vbuf, 1, 16 * half + arow) + kk - lo + acol);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            int32_t (&da)[4] = pa[2 * half + q];
            int32_t (&db)[4] = pb[2 * half + q];
            mma8(da, x1, q1[q], q1[q + 2]);
            mma8(db, x0, q1[q], q1[q + 2]);
            mma8(db, x1, q0[q], q0[q + 2]);
          }
        }
      }
      if (kCarry && win == n_win - 1) {
        // Accumulator (lane g (+8), rows 2t, 2t+1 of tile jt) -> output.
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            store1<kLimbs>(a, T.vb, r0 + 32 * sub + 8 * jt + 2 * t + (e & 1), T.hb,
                           T.j * kLanes + 16 * warp + g + 8 * (e >> 1), pa[jt][e], pb[jt][e]);
            pa[jt][e] = 0;
            pb[jt][e] = 0;
          }
        }
      } else if (!kCarry) {
        // Accumulator (lane g (+8), rows 2t, 2t+1 of tile jt) -> the
        // sub-tile's outputs [32 rows][128 lanes] in image buffer 1 (no
        // copy lands there in phase 2), then out 16 lanes a thread.
        uint8_t* const ot = K::sx(sm, 1, 0, 0);
        const int olane = T.hb * a.tc + T.j * kLanes + 16 * warp + g;
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ot[(8 * jt + 2 * t + (e & 1)) * kPieceLd + 16 * warp + g + 8 * (e >> 1)] =
                finish<kLimbs>(a, pa[jt][e], pb[jt][e], olane + 8 * (e >> 1));
          }
        }
        __syncthreads();
        store_rows(a, ot, T.vb, r0 + 32 * sub, T.hb, T.j * kLanes);
      }
      __syncthreads();
      vbuf ^= 1;
      lo = nlo;
      hi = nhi;
    }
    f = nf;
    win = nwin;
  }
}

template <int IN>
cudaError_t launch_vh_mma(const Args& a, dim3 grid, cudaStream_t s) {
  constexpr size_t bytes = VhMma<IN>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      fused_int8_vh_mma<IN>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  fused_int8_vh_mma<IN><<<grid, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <int R, int IN>
cudaError_t launch_hv_mma(const Args& a, int blocks, cudaStream_t s) {
  if (blocks < 1 || a.runs == nullptr) return cudaErrorInvalidValue;
  const size_t bytes = hv_mma_smem_bytes(a.kwin, HvMma<IN>::kTilePlanes, IN == kGamma);
  cudaError_t e = cudaFuncSetAttribute(
      fused_int8_hv_mma<R, IN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  fused_int8_hv_mma<R, IN><<<blocks, kThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

// The kernels of input mode IN at the host's slice height ``rows`` (vh: 32;
// hv: ``blocks`` thread blocks walking runs of tiles).
template <int IN>
cudaError_t launch_mma(bool hv, int rows, int blocks, const Args& a, dim3 grid, cudaStream_t s) {
  if (a.slice_range == nullptr || a.h_range == nullptr) return cudaErrorInvalidValue;
  if (hv) {
    if (a.kwin < kDepth || a.kwin > kHvMaxWin || a.kwin % kDepth != 0) {
      return cudaErrorInvalidValue;
    }
    if (rows == 32) return launch_hv_mma<32, IN>(a, blocks, s);
    if (rows == 64) return launch_hv_mma<64, IN>(a, blocks, s);
    if (rows == 128) return launch_hv_mma<128, IN>(a, blocks, s);
    return cudaErrorInvalidValue;
  }
  return rows == kRows ? launch_vh_mma<IN>(a, grid, s) : cudaErrorInvalidValue;
}

}  // namespace

extern "C" int avir_fused_int8(
    const void* x, const void* x_lo, void* out, int rows_in, int lanes_in, void* stream,
    int hv, int rows_out, int lanes_out,
    const void* v1, const void* v0, const void* v_comp, const void* offs_v,
    int bv, int tv, int wv,
    const void* h1p, const void* h0p, const void* h_comp,
    const void* offs_l, const void* rel,
    int bh, int n_ch, int win_c, int tc,
    const void* k_range, int n_slices,
    int rows, const void* slice_range, int n_slices_r, const void* h_range,
    const void* h1t, const void* h0t, int kwin, int lane_align,
    int blocks, const void* runs,
    int sh, float rec,
    int gamma, int alpha_lane, float in_gamma_mult, float out_gamma_mult,
    float scale, int even) {
  Args a;
  a.x = static_cast<const uint8_t*>(x);
  a.x_lo = static_cast<const uint8_t*>(x_lo);
  a.rows_in = rows_in;
  a.lanes_in = lanes_in;
  a.out = static_cast<uint8_t*>(out);
  a.rows_out = rows_out;
  a.lanes_out = lanes_out;
  a.v1 = static_cast<const int8_t*>(v1);
  a.v0 = static_cast<const int8_t*>(v0);
  a.v_comp = static_cast<const int32_t*>(v_comp);
  a.offs_v = static_cast<const int32_t*>(offs_v);
  a.tv = tv;
  a.wv = wv;
  a.h1p = static_cast<const uint32_t*>(h1p);
  a.h0p = static_cast<const uint32_t*>(h0p);
  a.h_comp = static_cast<const int32_t*>(h_comp);
  a.offs_l = static_cast<const int32_t*>(offs_l);
  a.rel = static_cast<const int32_t*>(rel);
  a.n_ch = n_ch;
  a.win_c = win_c;
  a.tc = tc;
  a.k_range = static_cast<const int32_t*>(k_range);
  a.n_slices = n_slices;
  a.slice_range = static_cast<const int32_t*>(slice_range);
  a.n_slices_r = n_slices_r;
  a.h_range = static_cast<const int32_t*>(h_range);
  a.h1t = static_cast<const int8_t*>(h1t);
  a.h0t = static_cast<const int8_t*>(h0t);
  a.kwin = kwin;
  a.bv = bv;
  a.runs = static_cast<const int32_t*>(runs);
  // Both planes' alignment with the limb-plane input.
  const uintptr_t xp = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(x_lo);
  a.vec4 = lane_align % 4 == 0 && lanes_in % 4 == 0 && xp % 4 == 0;
  a.vec16 = lane_align % 16 == 0 && lanes_in % 16 == 0 && xp % 16 == 0;
  a.sh = sh;
  a.rec = rec;
  a.epi.alpha_lane = alpha_lane;
  a.epi.in_gamma_mult = in_gamma_mult;
  a.epi.out_gamma_mult = out_gamma_mult;
  a.epi.scale = scale;
  a.epi.even = even;
  a.epi.trunc_bits = 0;
  a.epi.tm = 1.0f;
  a.epi.out_max = 255.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_lo != nullptr && !gamma) return static_cast<int>(cudaErrorInvalidValue);
  // One s8 tensor-core kernel over R-row slices for every input: the u8
  // image without gamma, K5's limb planes, or the u8 image linearized in
  // the kernel.  vh: a block a tile; hv: ``blocks`` blocks walking runs of
  // the bh * n_ch x bv * n_slices_r tiles (``runs``: each one's first).
  const dim3 grid(bh * n_ch, bv * n_slices_r);
  const cudaError_t e = !gamma            ? launch_mma<kU8>(hv, rows, blocks, a, grid, s)
                        : x_lo == nullptr ? launch_mma<kGamma>(hv, rows, blocks, a, grid, s)
                                          : launch_mma<kPlanes>(hv, rows, blocks, a, grid, s);
  return static_cast<int>(e);
}

// The kernels' dynamic shared memory (hv: hv_mma_smem_bytes; vh:
// VhMma<IN>::kBytes of the input mode that ``planes`` and ``table`` name:
// 1 kU8, 2 kPlanes, 2 and the table kGamma), for the host's copies of
// their layouts to be checked against.
extern "C" long long avir_int8_mma_smem_bytes(int hv, int kwin, int planes, int table) {
  if (!hv) {
    return static_cast<long long>(table         ? VhMma<kGamma>::kBytes
                                  : planes == 2 ? VhMma<kPlanes>::kBytes
                                                : VhMma<kU8>::kBytes);
  }
  return static_cast<long long>(hv_mma_smem_bytes(kwin, planes, table != 0));
}
