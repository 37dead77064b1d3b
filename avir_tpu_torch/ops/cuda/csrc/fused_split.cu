// Fused two-pass split-bf16 resize (K1, split2/split3 modes) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel
// avir_tpu/ops/pallas/fused_kernel.py: apply_fused_pallas -> _kernel
// (float branch) -> _rmul -> _finish, with its epilogue options (biased
// or round-half-even rounding, LANCIR's output ``scale``) and its
// in-kernel sRGB gamma stages (the degree-9 linearization as the input
// tile is staged, _linear_to_srgb before the epilogue, the C=4 alpha
// bypass; k1_common.cuh).  One launch computes the whole separable resize
// [rows_in, lanes_in] (u8, u16 or f32) -> [rows_out, lanes_out] (f32, u8
// or u16) from the error-free bf16 hi/lo tap splits; the float32
// intermediate lives only in shared memory.
//
// Arithmetic (the same function as the TPU kernel, summed in another
// order, so equal to float32 rounding and not bit for bit):
//   input       u8/u16 -> f32 exactly; gamma (GAMMA): x = poly9(x *
//               in_gamma_mult) (the alpha lane: x * in_gamma_mult);
//               split x = hi + lo with hi = bf16(x), lo = bf16(x - hi);
//               reads past the edge see 0.
//   a pass      split2: sum t_hi*x_hi + t_lo*x_hi
//               split3: ... + t_hi*x_lo
//               every product is bf16 x bf16, exact in f32; sums are f32
//               (fmaf of bf16-valued operands adds an exact product).
//   between     the f32 intermediate is split the same way.
//   epilogue    gamma: v = linear_to_srgb(v) * out_gamma_mult.
//               f32 out: store.  Integer out: v *= scale (when != 1);
//               v = floor(v + 0.5), rint(v) (round_mode "even"), or
//               floor(v / tm + 0.5) * tm when trunc_bits > 0 (IEEE
//               division); clamp to [0, out_max]; truncate to u8/u16.
//
// Design (the structure of fused_int8.cu, on float32 operands).  A thread
// block owns 32 output rows (a slice of one V block) and one 128-lane
// output chunk of one lane block; 256 threads each own 4 rows x 4 lanes
// and accumulate with fmaf on the CUDA cores.  Taps arrive as bf16 and
// are widened to f32 as they are staged in (dynamic) shared memory.
//   vh: for each 128-lane segment of the chunk's nonzero lane-tap rows,
//       the first pass computes the 32 x 128 intermediate over the
//       slice's nonzero V-tap rows (32 at a time), splits it into shared
//       memory, then the second pass adds that segment's share (32 lanes
//       of taps at a time).  72 KB of shared memory.
//   hv: for each 32-row group of the slice's nonzero V-tap rows, the
//       first pass computes those window rows x 128 chunk lanes over the
//       chunk's nonzero lane-tap rows, splits them into shared memory,
//       then the second pass adds the group's share.  80 KB.
// Only nonzero tap ranges are visited (k_range per 32-row slice, h_range
// per chunk), but the tap blocks inside them are dense, and the first
// pass is recomputed by every block whose window covers an input element
// (chip_smoke.py prints the factor).
//
// What bounds it on this card.  The image read once, the output written
// once and the taps bound it at tens of microseconds at the main-path
// sizes (bytes, 3.35 TB/s); the band MACs are a few GFLOP, microseconds
// at the bf16 tensor-core rate.  This first version runs 2-3 fmaf per
// MAC on the CUDA cores over dense tap blocks, with the recompute above,
// so it is bound by fmaf issue and shared-memory reads, far above that
// bound.  mma/wgmma on the bf16 splits, TMA staging and a first-pass
// intermediate shared across chunks are the planned ways down.
//
// With gamma the polynomial runs on every staged input element (as often
// as the first pass reads it) and the square roots once per output.
//
// Built without --use_fast_math: the division, the square roots and the
// rounding of the epilogue stay IEEE.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "k1_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;    // output rows per block
constexpr int kLanes = 128;  // output lanes per block (one chunk)
constexpr int kDepth = 32;   // contraction elements staged per step

struct Args {
  const void* x;
  int in_kind;              // 0 u8, 1 u16, 2 f32
  int rows_in, lanes_in;
  void* out;
  int out_kind;             // 0 f32, 1 u8, 2 u16
  int rows_out, lanes_out;
  const __nv_bfloat16* tvh;  // [Bv, Tv, Wv]
  const __nv_bfloat16* tvl;
  const int32_t* offs_v;    // [Bv]
  int tv, wv;
  const __nv_bfloat16* thh;  // [Bh, n_ch, win_c, 128]
  const __nv_bfloat16* thl;
  const int32_t* offs_l;    // [Bh]
  const int32_t* rel;       // [n_ch]
  int n_ch, win_c, tc;
  const int32_t* k_range;   // [Bv, n_slices, 2] nonzero V-tap rows, 32-aligned
  int n_slices;
  const int32_t* h_range;   // [Bh, n_ch, 2] nonzero lane-tap rows, 32-aligned
  k1::Epilogue epi;
};

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float widen(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// Image element as f32, zero past the edge.
__device__ __forceinline__ float load_x(const Args& a, int r, int l) {
  if (r >= a.rows_in || l >= a.lanes_in) return 0.0f;
  const size_t i = static_cast<size_t>(r) * a.lanes_in + l;
  if (a.in_kind == 0) return static_cast<float>(__ldg(static_cast<const uint8_t*>(a.x) + i));
  if (a.in_kind == 1) return static_cast<float>(__ldg(static_cast<const uint16_t*>(a.x) + i));
  return __ldg(static_cast<const float*>(a.x) + i);
}

// Image element as f32 after the pack stage.
template <bool GAMMA>
__device__ __forceinline__ float load_lin(const Args& a, int r, int l) {
  const float v = load_x(a, r, l);
  return GAMMA ? k1::gamma_in(a.epi, v, l) : v;
}

template <bool GAMMA>
__device__ __forceinline__ void store_one(const Args& a, size_t i, float v, int lane) {
  if (a.out_kind == 0) {
    static_cast<float*>(a.out)[i] = k1::finish_float<GAMMA>(a.epi, v, lane);
    return;
  }
  const int q = static_cast<int>(k1::finish_int<GAMMA>(a.epi, v, lane));
  if (a.out_kind == 1) {
    static_cast<uint8_t*>(a.out)[i] = static_cast<uint8_t>(q);
  } else {
    static_cast<uint16_t*>(a.out)[i] = static_cast<uint16_t>(q);
  }
}

template <bool GAMMA>
__device__ __forceinline__ void store_out(
    const Args& a, int vb, int r0, int hb, int j, const float (&acc)[4][4]) {
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
        store_one<GAMMA>(a, static_cast<size_t>(orow) * a.lanes_out + olane,
                         acc[i][jj], olane);
      }
    }
  }
}

// V taps of the block's 32 rows over contraction rows k0..k0+31, widened;
// rows past the V block are 0.
__device__ __forceinline__ void stage_v_taps(
    const Args& a, int vb, int r0, int k0, float (*sh)[kDepth], float (*sl)[kDepth]) {
  for (int e = threadIdx.x; e < kRows * kDepth; e += kThreads) {
    const int r = e / kDepth, k = e % kDepth;
    const int tr = r0 + r;
    float h = 0.0f, l = 0.0f;
    if (tr < a.tv) {
      const size_t off = (static_cast<size_t>(vb) * a.tv + tr) * a.wv + k0 + k;
      h = widen(a.tvh, off);
      l = widen(a.tvl, off);
    }
    sh[r][k] = h;
    sl[r][k] = l;
  }
}

// Lane taps of chunk ``chunk`` over window rows m0..m0+31, widened.
__device__ __forceinline__ void stage_h_taps(
    const Args& a, int chunk, int m0, float (*sh)[kLanes], float (*sl)[kLanes]) {
  const size_t base = (static_cast<size_t>(chunk) * a.win_c + m0) * kLanes;
  for (int e = threadIdx.x; e < kDepth * kLanes; e += kThreads) {
    sh[e / kLanes][e % kLanes] = widen(a.thh, base + e);
    sl[e / kLanes][e % kLanes] = widen(a.thl, base + e);
  }
}

template <bool S3V, bool S3H, bool GAMMA>
__global__ void __launch_bounds__(kThreads) fused_split_vh(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float (*svh)[kDepth] = reinterpret_cast<float (*)[kDepth]>(smem);  // V taps
  float (*svl)[kDepth] = svh + kRows;
  // x tile [32 rows][128 lanes] in the first pass, lane taps [32][128]
  // in the second.
  float (*sah)[kLanes] = reinterpret_cast<float (*)[kLanes]>(smem + 2 * kRows * kDepth);
  float (*sal)[kLanes] = sah + kDepth;
  float (*sih)[kLanes] = sal + kDepth;  // intermediate [32 rows][128 lanes]
  float (*sil)[kLanes] = sih + kRows;

  const int chunk = blockIdx.x;
  const int hb = chunk / a.n_ch, j = chunk % a.n_ch;
  const int vb = blockIdx.y / a.n_slices, sl = blockIdx.y % a.n_slices;
  const int r0 = sl * kRows;
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
  const int k_lo = a.k_range[2 * blockIdx.y];
  const int k_hi = a.k_range[2 * blockIdx.y + 1];
  const int h_lo = a.h_range[2 * chunk] / kLanes * kLanes;
  const int h_hi = a.h_range[2 * chunk + 1];
  const int row0 = a.offs_v[vb];
  const int lane0 = a.offs_l[hb] + a.rel[j];

  float acc[4][4] = {};
  for (int seg = h_lo; seg < h_hi; seg += kLanes) {
    // ---- first (vertical) pass over this 128-lane segment ----------
    float m[4][4] = {};
    for (int k0 = k_lo; k0 < k_hi; k0 += kDepth) {
      __syncthreads();
      stage_v_taps(a, vb, r0, k0, svh, svl);
      for (int e = tid; e < kDepth * kLanes; e += kThreads) {
        const int k = e / kLanes, l = e % kLanes;
        const float v = load_lin<GAMMA>(a, row0 + k0 + k, lane0 + seg + l);
        const float hi = bf(v);
        sah[k][l] = hi;
        sal[k][l] = bf(__fsub_rn(v, hi));
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kDepth; ++k) {
        const float4 xh = *reinterpret_cast<const float4*>(&sah[k][4 * tx]);
        const float xhv[4] = {xh.x, xh.y, xh.z, xh.w};
        float xlv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (S3V) {
          const float4 xl = *reinterpret_cast<const float4*>(&sal[k][4 * tx]);
          xlv[0] = xl.x; xlv[1] = xl.y; xlv[2] = xl.z; xlv[3] = xl.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float th = svh[4 * ty + i][k], tl = svl[4 * ty + i][k];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            m[i][jj] = fmaf(th, xhv[jj], m[i][jj]);
            m[i][jj] = fmaf(tl, xhv[jj], m[i][jj]);
            if (S3V) m[i][jj] = fmaf(th, xlv[jj], m[i][jj]);
          }
        }
      }
    }
    // ---- split the intermediate into shared memory -----------------
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 h, l;
      h.x = bf(m[i][0]); h.y = bf(m[i][1]); h.z = bf(m[i][2]); h.w = bf(m[i][3]);
      l.x = bf(__fsub_rn(m[i][0], h.x)); l.y = bf(__fsub_rn(m[i][1], h.y));
      l.z = bf(__fsub_rn(m[i][2], h.z)); l.w = bf(__fsub_rn(m[i][3], h.w));
      *reinterpret_cast<float4*>(&sih[4 * ty + i][4 * tx]) = h;
      *reinterpret_cast<float4*>(&sil[4 * ty + i][4 * tx]) = l;
    }
    // ---- second (horizontal) pass: this segment's share ------------
    for (int l0 = 0; l0 < kLanes; l0 += kDepth) {
      __syncthreads();
      stage_h_taps(a, chunk, seg + l0, sah, sal);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kDepth; ++d) {
        const float4 t1 = *reinterpret_cast<const float4*>(&sah[d][4 * tx]);
        const float4 t0 = *reinterpret_cast<const float4*>(&sal[d][4 * tx]);
        const float hh[4] = {t1.x, t1.y, t1.z, t1.w};
        const float hl[4] = {t0.x, t0.y, t0.z, t0.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float vh = sih[4 * ty + i][l0 + d];
          const float vl = S3H ? sil[4 * ty + i][l0 + d] : 0.0f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            acc[i][jj] = fmaf(vh, hh[jj], acc[i][jj]);
            acc[i][jj] = fmaf(vh, hl[jj], acc[i][jj]);
            if (S3H) acc[i][jj] = fmaf(vl, hh[jj], acc[i][jj]);
          }
        }
      }
    }
  }
  store_out<GAMMA>(a, vb, r0, hb, j, acc);
}

template <bool S3V, bool S3H, bool GAMMA>
__global__ void __launch_bounds__(kThreads) fused_split_hv(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float (*sxh)[kDepth] = reinterpret_cast<float (*)[kDepth]>(smem);  // x tile [32 rows][32 lanes]
  float (*sxl)[kDepth] = sxh + kRows;
  float (*svh)[kDepth] = sxl + kRows;                                 // V taps [32 rows][32 k]
  float (*svl)[kDepth] = svh + kRows;
  float (*sth)[kLanes] = reinterpret_cast<float (*)[kLanes]>(smem + 4 * kRows * kDepth);
  float (*stl)[kLanes] = sth + kDepth;  // lane taps [32 window lanes][128 lanes]
  float (*sih)[kLanes] = stl + kDepth;  // intermediate [32 window rows][128 lanes]
  float (*sil)[kLanes] = sih + kDepth;

  const int chunk = blockIdx.x;
  const int hb = chunk / a.n_ch, j = chunk % a.n_ch;
  const int vb = blockIdx.y / a.n_slices, sl = blockIdx.y % a.n_slices;
  const int r0 = sl * kRows;
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
  const int k_lo = a.k_range[2 * blockIdx.y];
  const int k_hi = a.k_range[2 * blockIdx.y + 1];
  const int m_lo = a.h_range[2 * chunk];
  const int m_hi = a.h_range[2 * chunk + 1];
  const int row0 = a.offs_v[vb];
  const int lane0 = a.offs_l[hb] + a.rel[j];

  float acc[4][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += kDepth) {
    // ---- first (horizontal) pass for window rows k0..k0+31 ---------
    float f[4][4] = {};
    for (int m0 = m_lo; m0 < m_hi; m0 += kDepth) {
      __syncthreads();
      for (int e = tid; e < kRows * kDepth; e += kThreads) {
        const int r = e / kDepth, l = e % kDepth;
        const float v = load_lin<GAMMA>(a, row0 + k0 + r, lane0 + m0 + l);
        const float hi = bf(v);
        sxh[r][l] = hi;
        sxl[r][l] = bf(__fsub_rn(v, hi));
      }
      stage_h_taps(a, chunk, m0, sth, stl);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kDepth; ++d) {
        const float4 t1 = *reinterpret_cast<const float4*>(&sth[d][4 * tx]);
        const float4 t0 = *reinterpret_cast<const float4*>(&stl[d][4 * tx]);
        const float hh[4] = {t1.x, t1.y, t1.z, t1.w};
        const float hl[4] = {t0.x, t0.y, t0.z, t0.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xh = sxh[4 * ty + i][d];
          const float xl = S3H ? sxl[4 * ty + i][d] : 0.0f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            f[i][jj] = fmaf(xh, hh[jj], f[i][jj]);
            f[i][jj] = fmaf(xh, hl[jj], f[i][jj]);
            if (S3H) f[i][jj] = fmaf(xl, hh[jj], f[i][jj]);
          }
        }
      }
    }
    // ---- split the intermediate; stage the V taps ------------------
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 h, l;
      h.x = bf(f[i][0]); h.y = bf(f[i][1]); h.z = bf(f[i][2]); h.w = bf(f[i][3]);
      l.x = bf(__fsub_rn(f[i][0], h.x)); l.y = bf(__fsub_rn(f[i][1], h.y));
      l.z = bf(__fsub_rn(f[i][2], h.z)); l.w = bf(__fsub_rn(f[i][3], h.w));
      *reinterpret_cast<float4*>(&sih[4 * ty + i][4 * tx]) = h;
      *reinterpret_cast<float4*>(&sil[4 * ty + i][4 * tx]) = l;
    }
    stage_v_taps(a, vb, r0, k0, svh, svl);
    __syncthreads();
    // ---- second (vertical) pass: this group's share ----------------
#pragma unroll 8
    for (int k = 0; k < kDepth; ++k) {
      const float4 ih = *reinterpret_cast<const float4*>(&sih[k][4 * tx]);
      const float ihv[4] = {ih.x, ih.y, ih.z, ih.w};
      float ilv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (S3V) {
        const float4 il = *reinterpret_cast<const float4*>(&sil[k][4 * tx]);
        ilv[0] = il.x; ilv[1] = il.y; ilv[2] = il.z; ilv[3] = il.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float th = svh[4 * ty + i][k], tl = svl[4 * ty + i][k];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[i][jj] = fmaf(th, ihv[jj], acc[i][jj]);
          acc[i][jj] = fmaf(tl, ihv[jj], acc[i][jj]);
          if (S3V) acc[i][jj] = fmaf(th, ilv[jj], acc[i][jj]);
        }
      }
    }
  }
  store_out<GAMMA>(a, vb, r0, hb, j, acc);
}

constexpr size_t kSmemVh = (2 * kRows * kDepth + 2 * kDepth * kLanes + 2 * kRows * kLanes) * sizeof(float);
constexpr size_t kSmemHv = (4 * kRows * kDepth + 2 * kDepth * kLanes + 2 * kDepth * kLanes) * sizeof(float);

template <bool S3V, bool S3H, bool GAMMA>
cudaError_t launch(bool hv, const Args& a, dim3 grid, cudaStream_t s) {
  if (hv) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_split_hv<S3V, S3H, GAMMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemHv));
    if (e != cudaSuccess) return e;
    fused_split_hv<S3V, S3H, GAMMA><<<grid, kThreads, kSmemHv, s>>>(a);
  } else {
    cudaError_t e = cudaFuncSetAttribute(
        fused_split_vh<S3V, S3H, GAMMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemVh));
    if (e != cudaSuccess) return e;
    fused_split_vh<S3V, S3H, GAMMA><<<grid, kThreads, kSmemVh, s>>>(a);
  }
  return cudaGetLastError();
}

template <bool GAMMA>
cudaError_t launch_modes(bool hv, bool s3v, bool s3h, const Args& a, dim3 grid,
                         cudaStream_t s) {
  if (s3v) {
    return s3h ? launch<true, true, GAMMA>(hv, a, grid, s)
               : launch<true, false, GAMMA>(hv, a, grid, s);
  }
  return s3h ? launch<false, true, GAMMA>(hv, a, grid, s)
             : launch<false, false, GAMMA>(hv, a, grid, s);
}

}  // namespace

extern "C" int avir_fused_split(
    int hv, int split3_v, int split3_h,
    int in_kind, int out_kind,
    const void* x, int rows_in, int lanes_in,
    void* out, int rows_out, int lanes_out,
    const void* tvh, const void* tvl, const void* offs_v,
    int bv, int tv, int wv,
    const void* thh, const void* thl, const void* offs_l, const void* rel,
    int bh, int n_ch, int win_c, int tc,
    const void* k_range, int n_slices, const void* h_range,
    float out_max, float tm, int trunc_bits,
    int gamma, int alpha_lane, float in_gamma_mult, float out_gamma_mult,
    float scale, int even,
    void* stream) {
  Args a;
  a.x = x;
  a.in_kind = in_kind;
  a.rows_in = rows_in;
  a.lanes_in = lanes_in;
  a.out = out;
  a.out_kind = out_kind;
  a.rows_out = rows_out;
  a.lanes_out = lanes_out;
  a.tvh = static_cast<const __nv_bfloat16*>(tvh);
  a.tvl = static_cast<const __nv_bfloat16*>(tvl);
  a.offs_v = static_cast<const int32_t*>(offs_v);
  a.tv = tv;
  a.wv = wv;
  a.thh = static_cast<const __nv_bfloat16*>(thh);
  a.thl = static_cast<const __nv_bfloat16*>(thl);
  a.offs_l = static_cast<const int32_t*>(offs_l);
  a.rel = static_cast<const int32_t*>(rel);
  a.n_ch = n_ch;
  a.win_c = win_c;
  a.tc = tc;
  a.k_range = static_cast<const int32_t*>(k_range);
  a.n_slices = n_slices;
  a.h_range = static_cast<const int32_t*>(h_range);
  a.epi.alpha_lane = alpha_lane;
  a.epi.in_gamma_mult = in_gamma_mult;
  a.epi.out_gamma_mult = out_gamma_mult;
  a.epi.scale = scale;
  a.epi.even = even;
  a.epi.trunc_bits = trunc_bits;
  a.epi.tm = tm;
  a.epi.out_max = out_max;
  const dim3 grid(bh * n_ch, bv * n_slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      gamma ? launch_modes<true>(hv, split3_v, split3_h, a, grid, s)
            : launch_modes<false>(hv, split3_v, split3_h, a, grid, s);
  return static_cast<int>(e);
}
