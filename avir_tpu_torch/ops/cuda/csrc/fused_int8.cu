// Fused two-pass int8 resize (K1, int8 mode) for NVIDIA Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// avir_tpu/ops/pallas/fused_kernel.py: apply_fused_pallas -> _kernel ->
// _int8_passes -> _finish, in its int8 mode, with its epilogue options:
// the biased or round-half-even rounding, LANCIR's output ``scale``, and
// the in-kernel sRGB gamma stages (the u8 linearization quantized to
// 13-bit linear light, _linear_to_srgb, the C=4 alpha bypass).  One
// launch computes the whole separable resize [rows_in, lanes_in] u8 ->
// [rows_out, lanes_out] u8 from radix-128 two-limb s8 taps; the 15-bit
// inter-pass intermediate lives only in shared memory.
//
// Arithmetic (bit-exact with the TPU kernel): every product and sum
// before the float recombination is an exact s32 integer, and each
// output's recombination uses only that output's full sums, so the
// result does not depend on the tiling.  Float steps use the _rn
// intrinsics so that no FMA contraction can move a rounding
// (k1_common.cuh).
//
//   input       no gamma: xs = s8(x ^ 0x80) = x - 128; reads past the
//               edge see 0.
//               gamma (GAMMA): xq = rint(poly7(x * in_gamma_mult) * 2^13)
//               (the alpha lane: rint(x * in_gamma_mult * 2^13)), split
//               into s8 limbs xq1 = (xq + 64) >> 7, xq0 = xq - 128*xq1,
//               staged as two planes; reads past the edge see xq = 0.
//               Each block first evaluates xq for all 256 u8 values (512
//               with an alpha lane) into a shared table
//               (k1::fill_q13_table), and every staged element is one
//               table read: the same bits as the polynomial, which used to
//               run on every staged element.
//               gamma from limb planes (GAMMA_PRE: the template's PRE,
//               _kernel's x_lo input there): xq1 and xq0 read from the two
//               s8 planes of the prologue kernel K5 (gamma_prologue.cu),
//               which computed them with the same gamma_in_q13; the rest
//               of the kernel is unchanged.
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
// Design.  A thread block owns 32 output rows (a slice of one V block)
// and one 128-lane output chunk of one lane block; 256 threads each own
// 4 rows x 4 lanes.  Products are dp4a (4 s8 MACs into s32) from shared
// memory.  Operands are staged "packed along the contraction": a 32-bit
// word holds 4 consecutive contraction elements, so V taps (row-major)
// and the horizontal taps (packed on the host, [win_c/4][128] words)
// load as they are, and the image tile is transposed into that form as
// it is stored.
//   vh: for each 128-lane segment of the chunk's win_c-lane window, the
//       first pass computes x15 for the 32 rows x 128 lanes over the
//       slice's nonzero V-tap rows, then the second pass adds that
//       segment's share of pa/pb.  The first pass is thus recomputed by
//       every chunk whose window covers a lane (about win_c / (128 * s)
//       chunks for a downsize by s: 2 at 7680x4320 -> 1920x1080, where
//       win_c = 1024 and s = 4) and by every slice whose 32-aligned row
//       range covers a row (1.5 there): each input byte is read ~3
//       times.  Dynamic shared memory: 46 KB, 50 KB with gamma's second
//       input plane, 52 KB with its table.
//   hv: for each 32-row segment of the slice's nonzero V-tap rows, the
//       first pass computes x15 for those window rows x 128 chunk lanes
//       over the win_c window lanes, then the second pass adds the
//       segment's share.  Window rows shared by neighbouring slices are
//       recomputed by each (4x at 1920x1080 -> 3840x2160), and window
//       lanes by every chunk that covers them (8x there): each input
//       byte is read ~32 times.
//   Staging writes whole words: a thread loads the 4 contraction elements
//   of one word (4 rows of one lane in vh, 4 lanes of one row in hv) and
//   stores them with one 32-bit shared-memory store.  With gamma the
//   first pass makes 3 products instead of 2.
//   chip_smoke.py prints these factors ("first_pass_reads_per_input").
//
// What bounds it on this card.  The image bytes read once plus the
// output written once bound the kernel at tens of microseconds at the
// main-path sizes (memory-bound by the data sheet's 3.35 TB/s; the band
// MACs are ~1e10 int8 operations, a few microseconds at the tensor
// cores' rate).  This first version runs its products on the CUDA
// cores (dp4a) over dense tap blocks (a 128-lane chunk's window is
// win_c lanes however narrow its band) and recomputes the first pass as
// above, so it is bound by dp4a issue, far above that bound.  Tensor
// core products (mma/wgmma), TMA staging and a first-pass intermediate
// shared across chunks are the planned ways down.

#include <cstdint>
#include <cuda_runtime.h>

#include "k1_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;    // output rows per block
constexpr int kLanes = 128;  // output lanes per block (one chunk)
constexpr int kDepth = 32;   // contraction elements staged per step
constexpr int kDepth4 = kDepth / 4;

struct Args {
  const uint8_t* x;        // the u8 image, or (GAMMA_PRE) the hi limb plane
  const uint8_t* x_lo;     // GAMMA_PRE: the lo limb plane
  int rows_in, lanes_in;   // extent of x (and x_lo)
  uint8_t* out;
  int rows_out, lanes_out;
  const int8_t* v1;        // [Bv, Tv, Wv]
  const int8_t* v0;
  const int32_t* v_comp;   // [Bv, Tv] (vh without gamma)
  const int32_t* offs_v;   // [Bv]
  int tv, wv;
  const uint32_t* h1p;     // [Bh, n_ch, win_c/4, 128] packed along win_c
  const uint32_t* h0p;
  const int32_t* h_comp;   // [Bh, n_ch, 128] (hv without gamma)
  const int32_t* offs_l;   // [Bh]
  const int32_t* rel;      // [n_ch]
  int n_ch, win_c, tc;
  const int32_t* k_range;  // [Bv, n_slices, 2] nonzero V-tap rows, 32-aligned
  int n_slices;
  int sh;                  // first-pass requantizing shift (>= 1)
  float rec;               // 2^-(x_shift + second-pass q_shift)
  k1::Epilogue epi;
};

// Image byte as s8 (x - 128), zero past the edge.
__device__ __forceinline__ uint8_t load_xs(const Args& a, int r, int l) {
  uint8_t v = 0;
  if (r < a.rows_in && l < a.lanes_in) {
    v = __ldg(a.x + static_cast<size_t>(r) * a.lanes_in + l);
  }
  return v ^ 0x80u;
}

// Image element as 13-bit linear light in two s8 limbs (hi, lo); zero
// past the edge.  From the block's table of gamma_in_q13, or (PRE) read
// from K5's two planes (x, x_lo).
template <bool PRE>
__device__ __forceinline__ void load_limbs(const Args& a, const int32_t (*q13)[256],
                                           int r, int l, int32_t* hi, int32_t* lo) {
  *hi = 0;
  *lo = 0;
  if (r >= a.rows_in || l >= a.lanes_in) return;
  const size_t i = static_cast<size_t>(r) * a.lanes_in + l;
  if (PRE) {
    *hi = static_cast<int8_t>(__ldg(a.x + i));
    *lo = static_cast<int8_t>(__ldg(a.x_lo + i));
    return;
  }
  const int32_t q = k1::q13_of(a.epi, q13, __ldg(a.x + i), l);
  *hi = k1::limb_hi(q);
  *lo = q - *hi * 128;
}

__device__ __forceinline__ uint32_t byte_of(int32_t v, int i) {
  return (static_cast<uint32_t>(v) & 0xffu) << (8 * i);
}

// Four consecutive contraction elements from (r, l), stepping (dr, dl),
// packed into one word of each input plane: xs, or with gamma the xq1 /
// xq0 limbs.
template <bool GAMMA, bool PRE>
__device__ __forceinline__ void pack4(const Args& a, const int32_t (*q13)[256],
                                      int r, int l, int dr, int dl,
                                      uint32_t* w1, uint32_t* w0) {
  uint32_t p1 = 0, p0 = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (GAMMA) {
      int32_t hi, lo;
      load_limbs<PRE>(a, q13, r + i * dr, l + i * dl, &hi, &lo);
      p1 |= byte_of(hi, i);
      p0 |= byte_of(lo, i);
    } else {
      p1 |= byte_of(load_xs(a, r + i * dr, l + i * dl), i);
    }
  }
  *w1 = p1;
  *w0 = p0;
}

template <bool GAMMA>
__device__ __forceinline__ uint8_t finish(const Args& a, int32_t pa, int32_t pb, int lane) {
  const float acc = k1::recombine(pa, pb, a.rec);
  return static_cast<uint8_t>(static_cast<int>(k1::finish_int<GAMMA>(a.epi, acc, lane)));
}

// V tap limbs of the block's 32 rows over contraction rows k0..k0+31:
// one word (4 taps) per thread and limb; rows past the V block are 0.
__device__ __forceinline__ void stage_v_taps(
    const Args& a, int vb, int r0, int k0,
    uint32_t (*s1)[kDepth4], uint32_t (*s0)[kDepth4]) {
  const int r = threadIdx.x / kDepth4, w = threadIdx.x % kDepth4;
  const int tr = r0 + r;
  uint32_t q1 = 0, q0 = 0;
  if (tr < a.tv) {
    const size_t off = (static_cast<size_t>(vb) * a.tv + tr) * a.wv + k0 + 4 * w;
    q1 = __ldg(reinterpret_cast<const uint32_t*>(a.v1 + off));
    q0 = __ldg(reinterpret_cast<const uint32_t*>(a.v0 + off));
  }
  s1[r][w] = q1;
  s0[r][w] = q0;
}

template <bool GAMMA>
__device__ __forceinline__ void store_out(
    const Args& a, int vb, int r0, int hb, int j,
    const int32_t (&pa)[4][4], const int32_t (&pb)[4][4]) {
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tr = r0 + 4 * ty + i;
    const int orow = vb * a.tv + tr;
    if (tr >= a.tv || orow >= a.rows_out) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int cl = j * kLanes + 4 * tx + jj;
      const int olane = hb * a.tc + cl;
      if (cl < a.tc && olane < a.lanes_out) {
        a.out[static_cast<size_t>(orow) * a.lanes_out + olane] =
            finish<GAMMA>(a, pa[i][jj], pb[i][jj], olane);
      }
    }
  }
}

// Dynamic shared memory of the vh kernel, in 32-bit words.
constexpr int kVhTapWords = 2 * kRows * kDepth4;            // sv1, sv0
constexpr int kVhXWords = kDepth4 * kLanes;                 // one input plane
constexpr int kVhLimbWords = 2 * kRows * (kLanes / 4);      // sl1, sl0
constexpr int kVhHWords = 2 * (kLanes / 4) * kLanes;        // sh1, sh0
constexpr int kTableWords = 2 * 256;                        // q13
template <bool GAMMA, bool PRE>
constexpr size_t vh_smem_bytes() {
  return (kVhTapWords + (GAMMA ? 2 : 1) * kVhXWords + kVhLimbWords + kVhHWords +
          (GAMMA && !PRE ? kTableWords : 0)) * 4;
}

template <bool GAMMA, bool PRE>
__global__ void __launch_bounds__(kThreads) fused_int8_vh(const Args a) {
  const int chunk = blockIdx.x;
  const int hb = chunk / a.n_ch, j = chunk % a.n_ch;
  const int vb = blockIdx.y / a.n_slices, sl = blockIdx.y % a.n_slices;
  const int r0 = sl * kRows;
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t (*sv1)[kDepth4] = reinterpret_cast<uint32_t (*)[kDepth4]>(smem);  // V tap limbs
  uint32_t (*sv0)[kDepth4] = sv1 + kRows;
  // Input tile, packed along rows: xs, or with gamma the xq1 / xq0 planes.
  uint32_t (*sx1)[kLanes] = reinterpret_cast<uint32_t (*)[kLanes]>(smem + kVhTapWords);
  uint32_t (*sx0)[kLanes] = sx1 + (GAMMA ? kDepth4 : 0);
  // x1/x0 limbs, packed along lanes.
  uint32_t (*sl1)[kLanes / 4] = reinterpret_cast<uint32_t (*)[kLanes / 4]>(
      smem + kVhTapWords + (GAMMA ? 2 : 1) * kVhXWords);
  uint32_t (*sl0)[kLanes / 4] = sl1 + kRows;
  uint32_t (*sh1)[kLanes] = reinterpret_cast<uint32_t (*)[kLanes]>(sl0 + kRows);  // H taps
  uint32_t (*sh0)[kLanes] = sh1 + kLanes / 4;
  int32_t (*q13)[256] = reinterpret_cast<int32_t (*)[256]>(sh0 + kLanes / 4);
  if (GAMMA && !PRE) k1::fill_q13_table(a.epi, q13);

  const int k_lo = a.k_range[2 * blockIdx.y];
  const int k_hi = a.k_range[2 * blockIdx.y + 1];
  const int row0 = a.offs_v[vb];
  const int lane0 = a.offs_l[hb] + a.rel[j];
  int32_t comp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tr = r0 + 4 * ty + i;
    comp[i] = (!GAMMA && tr < a.tv) ? a.v_comp[vb * a.tv + tr] : 0;
  }

  int32_t pa[4][4] = {}, pb[4][4] = {};
  for (int seg = 0; seg < a.win_c; seg += kLanes) {
    // ---- first (vertical) pass over this 128-lane segment ----------
    // m1/m0: products with xs (no gamma), or m1 = q1v.xq1, m0 = q1v.xq0
    // and m2 = q0v.xq1 (gamma).
    int32_t m1[4][4] = {}, m0[4][4] = {}, m2[4][4] = {};
    for (int k0 = k_lo; k0 < k_hi; k0 += kDepth) {
      __syncthreads();
      stage_v_taps(a, vb, r0, k0, sv1, sv0);
      // One word per (4 rows, lane): rows k0 + 4*k4 .. + 3.
      for (int e = tid; e < kDepth4 * kLanes; e += kThreads) {
        const int k4 = e / kLanes, l = e % kLanes;
        uint32_t w1, w0;
        pack4<GAMMA, PRE>(a, q13, row0 + k0 + 4 * k4, lane0 + seg + l, 1, 0, &w1, &w0);
        sx1[k4][l] = w1;
        if (GAMMA) sx0[k4][l] = w0;
      }
      __syncthreads();
#pragma unroll
      for (int k4 = 0; k4 < kDepth4; ++k4) {
        const uint4 xb = *reinterpret_cast<const uint4*>(&sx1[k4][4 * tx]);
        const int xv[4] = {static_cast<int>(xb.x), static_cast<int>(xb.y),
                           static_cast<int>(xb.z), static_cast<int>(xb.w)};
        int xl[4] = {0, 0, 0, 0};
        if (GAMMA) {
          const uint4 xc = *reinterpret_cast<const uint4*>(&sx0[k4][4 * tx]);
          xl[0] = static_cast<int>(xc.x); xl[1] = static_cast<int>(xc.y);
          xl[2] = static_cast<int>(xc.z); xl[3] = static_cast<int>(xc.w);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q1 = static_cast<int>(sv1[4 * ty + i][k4]);
          const int q0 = static_cast<int>(sv0[4 * ty + i][k4]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (GAMMA) {
              m1[i][jj] = __dp4a(q1, xv[jj], m1[i][jj]);
              m0[i][jj] = __dp4a(q1, xl[jj], m0[i][jj]);
              m2[i][jj] = __dp4a(q0, xv[jj], m2[i][jj]);
            } else {
              m1[i][jj] = __dp4a(q1, xv[jj], m1[i][jj]);
              m0[i][jj] = __dp4a(q0, xv[jj], m0[i][jj]);
            }
          }
        }
      }
    }
    // ---- requantize to two s8 limbs, kept in shared memory ---------
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t w1 = 0, w0 = 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int32_t fq = GAMMA ? m1[i][jj] * 16384 + (m0[i][jj] + m2[i][jj]) * 128
                                 : m1[i][jj] * 128 + m0[i][jj] + comp[i];
        const int32_t x15 = k1::requant(fq, a.sh);
        const int32_t x1 = k1::limb_hi(x15);
        w1 |= byte_of(x1, jj);
        w0 |= byte_of(x15 - x1 * 128, jj);
      }
      sl1[4 * ty + i][tx] = w1;
      sl0[4 * ty + i][tx] = w0;
    }
    {
      const size_t base =
          (static_cast<size_t>(chunk) * (a.win_c / 4) + seg / 4) * kLanes / 4;
      const uint4* g1 = reinterpret_cast<const uint4*>(a.h1p) + base;
      const uint4* g0 = reinterpret_cast<const uint4*>(a.h0p) + base;
      for (int e = tid; e < (kLanes / 4) * kLanes / 4; e += kThreads) {
        reinterpret_cast<uint4*>(&sh1[0][0])[e] = __ldg(g1 + e);
        reinterpret_cast<uint4*>(&sh0[0][0])[e] = __ldg(g0 + e);
      }
    }
    __syncthreads();
    // ---- second (horizontal) pass: this segment's share ------------
#pragma unroll 4
    for (int k4 = 0; k4 < kLanes / 4; ++k4) {
      const uint4 t1 = *reinterpret_cast<const uint4*>(&sh1[k4][4 * tx]);
      const uint4 t0 = *reinterpret_cast<const uint4*>(&sh0[k4][4 * tx]);
      const int h1[4] = {static_cast<int>(t1.x), static_cast<int>(t1.y),
                         static_cast<int>(t1.z), static_cast<int>(t1.w)};
      const int h0[4] = {static_cast<int>(t0.x), static_cast<int>(t0.y),
                         static_cast<int>(t0.z), static_cast<int>(t0.w)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x1 = static_cast<int>(sl1[4 * ty + i][k4]);
        const int x0 = static_cast<int>(sl0[4 * ty + i][k4]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          pa[i][jj] = __dp4a(x1, h1[jj], pa[i][jj]);
          pb[i][jj] = __dp4a(x0, h1[jj], pb[i][jj]);
          pb[i][jj] = __dp4a(x1, h0[jj], pb[i][jj]);
        }
      }
    }
  }
  store_out<GAMMA>(a, vb, r0, hb, j, pa, pb);
}

template <bool GAMMA, bool PRE>
__global__ void __launch_bounds__(kThreads) fused_int8_hv(const Args a) {
  const int chunk = blockIdx.x;
  const int hb = chunk / a.n_ch, j = chunk % a.n_ch;
  const int vb = blockIdx.y / a.n_slices, sl = blockIdx.y % a.n_slices;
  const int r0 = sl * kRows;
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;

  // Input tile packed along lanes: xs, or with gamma the xq1 / xq0 planes.
  __shared__ uint32_t sxa[GAMMA ? 2 : 1][kRows][kDepth4];
  __shared__ __align__(16) uint32_t st1[kDepth4][kLanes];    // H taps, packed
  __shared__ __align__(16) uint32_t st0[kDepth4][kLanes];
  __shared__ __align__(16) uint32_t sl1[kDepth4][kLanes];    // x1/x0, packed along rows
  __shared__ __align__(16) uint32_t sl0[kDepth4][kLanes];
  __shared__ uint32_t sv1[kRows][kDepth4];                   // V tap limbs
  __shared__ uint32_t sv0[kRows][kDepth4];
  __shared__ int32_t q13[GAMMA && !PRE ? 2 : 1][256];        // gamma_in_q13 table
  if (GAMMA && !PRE) k1::fill_q13_table(a.epi, q13);

  const int k_lo = a.k_range[2 * blockIdx.y];
  const int k_hi = a.k_range[2 * blockIdx.y + 1];
  const int row0 = a.offs_v[vb];
  const int lane0 = a.offs_l[hb] + a.rel[j];
  int32_t comp[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    comp[jj] = GAMMA ? 0 : a.h_comp[chunk * kLanes + 4 * tx + jj];
  }
  const size_t tap_base = static_cast<size_t>(chunk) * (a.win_c / 4) * kLanes / 4;

  int32_t pa[4][4] = {}, pb[4][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += kDepth) {
    // ---- first (horizontal) pass for window rows k0..k0+31 ---------
    // f1/f0: products with xs (no gamma), or f1 = xq1.h1, f0 = xq0.h1
    // and f2 = xq1.h0 (gamma).
    int32_t f1[4][4] = {}, f0[4][4] = {}, f2[4][4] = {};
    for (int m0 = 0; m0 < a.win_c; m0 += kDepth) {
      __syncthreads();
      {
        // One word per (row, 4 lanes): one per thread.
        static_assert(kRows * kDepth4 == kThreads, "one staged word per thread");
        const int r = tid / kDepth4, l4 = tid % kDepth4;
        uint32_t w1, w0;
        pack4<GAMMA, PRE>(a, q13, row0 + k0 + r, lane0 + m0 + 4 * l4, 0, 1, &w1, &w0);
        sxa[0][r][l4] = w1;
        if (GAMMA) sxa[GAMMA ? 1 : 0][r][l4] = w0;
      }
      {
        const uint4* g1 = reinterpret_cast<const uint4*>(a.h1p) + tap_base + m0 / 4 * kLanes / 4;
        const uint4* g0 = reinterpret_cast<const uint4*>(a.h0p) + tap_base + m0 / 4 * kLanes / 4;
        reinterpret_cast<uint4*>(&st1[0][0])[tid] = __ldg(g1 + tid);
        reinterpret_cast<uint4*>(&st0[0][0])[tid] = __ldg(g0 + tid);
      }
      __syncthreads();
#pragma unroll
      for (int m4 = 0; m4 < kDepth4; ++m4) {
        const uint4 t1 = *reinterpret_cast<const uint4*>(&st1[m4][4 * tx]);
        const uint4 t0 = *reinterpret_cast<const uint4*>(&st0[m4][4 * tx]);
        const int h1[4] = {static_cast<int>(t1.x), static_cast<int>(t1.y),
                           static_cast<int>(t1.z), static_cast<int>(t1.w)};
        const int h0[4] = {static_cast<int>(t0.x), static_cast<int>(t0.y),
                           static_cast<int>(t0.z), static_cast<int>(t0.w)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int xv = static_cast<int>(sxa[0][4 * ty + i][m4]);
          const int xl = GAMMA ? static_cast<int>(sxa[GAMMA ? 1 : 0][4 * ty + i][m4]) : 0;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            f1[i][jj] = __dp4a(xv, h1[jj], f1[i][jj]);
            if (GAMMA) {
              f0[i][jj] = __dp4a(xl, h1[jj], f0[i][jj]);
              f2[i][jj] = __dp4a(xv, h0[jj], f2[i][jj]);
            } else {
              f0[i][jj] = __dp4a(xv, h0[jj], f0[i][jj]);
            }
          }
        }
      }
    }
    // ---- requantize; pack each lane's 4 rows into one word ---------
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t w1 = 0, w0 = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int32_t fq = GAMMA ? f1[i][jj] * 16384 + (f0[i][jj] + f2[i][jj]) * 128
                                 : f1[i][jj] * 128 + f0[i][jj] + comp[jj];
        const int32_t x15 = k1::requant(fq, a.sh);
        const int32_t x1 = k1::limb_hi(x15);
        w1 |= byte_of(x1, i);
        w0 |= byte_of(x15 - x1 * 128, i);
      }
      sl1[ty][4 * tx + jj] = w1;
      sl0[ty][4 * tx + jj] = w0;
    }
    stage_v_taps(a, vb, r0, k0, sv1, sv0);
    __syncthreads();
    // ---- second (vertical) pass: this segment's share --------------
#pragma unroll
    for (int k4 = 0; k4 < kDepth4; ++k4) {
      const uint4 l1 = *reinterpret_cast<const uint4*>(&sl1[k4][4 * tx]);
      const uint4 l0 = *reinterpret_cast<const uint4*>(&sl0[k4][4 * tx]);
      const int x1[4] = {static_cast<int>(l1.x), static_cast<int>(l1.y),
                         static_cast<int>(l1.z), static_cast<int>(l1.w)};
      const int x0[4] = {static_cast<int>(l0.x), static_cast<int>(l0.y),
                         static_cast<int>(l0.z), static_cast<int>(l0.w)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q1 = static_cast<int>(sv1[4 * ty + i][k4]);
        const int q0 = static_cast<int>(sv0[4 * ty + i][k4]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          pa[i][jj] = __dp4a(q1, x1[jj], pa[i][jj]);
          pb[i][jj] = __dp4a(q1, x0[jj], pb[i][jj]);
          pb[i][jj] = __dp4a(q0, x1[jj], pb[i][jj]);
        }
      }
    }
  }
  store_out<GAMMA>(a, vb, r0, hb, j, pa, pb);
}

template <bool GAMMA, bool PRE>
cudaError_t launch(bool hv, const Args& a, dim3 grid, cudaStream_t s) {
  if (hv) {
    fused_int8_hv<GAMMA, PRE><<<grid, kThreads, 0, s>>>(a);
  } else {
    constexpr size_t bytes = vh_smem_bytes<GAMMA, PRE>();
    cudaError_t e = cudaFuncSetAttribute(
        fused_int8_vh<GAMMA, PRE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    fused_int8_vh<GAMMA, PRE><<<grid, kThreads, bytes, s>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int avir_fused_int8(
    int hv,
    const void* x, const void* x_lo, int rows_in, int lanes_in,
    void* out, int rows_out, int lanes_out,
    const void* v1, const void* v0, const void* v_comp, const void* offs_v,
    int bv, int tv, int wv,
    const void* h1p, const void* h0p, const void* h_comp,
    const void* offs_l, const void* rel,
    int bh, int n_ch, int win_c, int tc,
    const void* k_range, int n_slices,
    int sh, float rec,
    int gamma, int alpha_lane, float in_gamma_mult, float out_gamma_mult,
    float scale, int even,
    void* stream) {
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
  const dim3 grid(bh * n_ch, bv * n_slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_lo != nullptr && !gamma) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = !gamma          ? launch<false, false>(hv, a, grid, s)
                        : x_lo != nullptr ? launch<true, true>(hv, a, grid, s)
                                          : launch<true, false>(hv, a, grid, s);
  return static_cast<int>(e);
}
