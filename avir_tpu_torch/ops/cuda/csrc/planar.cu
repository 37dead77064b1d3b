// Planar fused split-bf16 resizes (K7 and K8) for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas kernels of the JAX package, both the split-bf16
// fused V -> H resize with a DENSE per-channel H operator (the lane form
// of the H pass at C = 1, [Wh, Th] per block, instead of K1's
// channel-diagonal [Wh*C, Th*C]):
//   K7  avir_tpu/ops/pallas/planar_kernel.py: apply_planar_pallas ->
//       _kernel.  Input planar-stacked [c*hp, wp] (plane p's row r at
//       p*hp + r); output planar [c*Bv*Tv, Bh*Th].  Gamma with a whole
//       alpha plane bypassing the curves (scaled only).
//   K8  avir_tpu/ops/pallas/planar2_kernel.py: apply_planar2_pallas ->
//       _kernel.  Input interleaved [rows, W*C]; output channel-grouped
//       [Bv*Tv, Bh*C*Th].  Gamma-in on the interleaved window with the
//       C = 4 alpha lane mask; gamma-out per channel, skipping alpha_ch.
// The template parameter INTERLEAVED selects the input layout; nothing
// else differs.  On the TPU, K8 de-interleaves the V result in VMEM with
// strided lane slices, which Mosaic cannot lower; here each thread block
// works on one channel and reads its pixels at a lane stride of C, so
// the de-interleave is only the address of the staged read.
//
// Arithmetic (the same function as the TPU kernels, summed in another
// order, so equal to float32 rounding and not bit for bit), as in
// fused_split.cu: input u8/u16 -> f32 exactly (or f32); gamma: x =
// poly9(x * in_gamma_mult) (the alpha plane / lane: x * in_gamma_mult);
// a pass in split2 sums t_hi*x_hi + t_lo*x_hi, split3 adds t_hi*x_lo,
// with hi = bf16(x), lo = bf16(x - hi) (__float2bfloat16_rn and __fsub_rn,
// so nvcc cannot contract the residual); every product is bf16 x bf16,
// exact in f32; the intermediate is split the same way; the epilogue is
// k1_common.cuh's (gamma-out, out_gamma_mult, scale, rounding, clamp).
//
// Design (fused_split.cu's vh kernel on one channel).  A thread block owns
// 32 output rows (a slice of one V block), one 128-lane output chunk of
// one H block, and one channel; 256 threads each own 4 rows x 4 lanes and
// accumulate with fmaf on the CUDA cores.  For each 128-pixel segment of
// the chunk's nonzero H-tap rows, the V pass computes the 32 x 128
// intermediate over the slice's nonzero V-tap rows, splits it into shared
// memory, and the H pass adds that segment's share.  72 KB of dynamic
// shared memory.  The alpha bypass is a per-block choice (plane or
// channel), passed to k1_common.cuh's stages as a lane that is or is not
// the alpha lane.
//
// What bounds it on this card.  The image read once and the output
// written once (bytes, 3.35 TB/s); the band MACs are a few GFLOP at the
// bf16 tensor-core rate.  This first version runs 2-3 fmaf per MAC on
// the CUDA cores over dense tap blocks, and every block whose window
// covers an input element reads it again, so it is bound by fmaf issue
// and shared-memory reads, far above that bound.
//
// Built without --use_fast_math: the epilogue's division, square roots
// and rounding stay IEEE.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "k1_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;    // output rows per block
constexpr int kLanes = 128;  // output pixels per block (one chunk)
constexpr int kDepth = 32;   // contraction elements staged per step

struct Args {
  const void* x;
  int in_kind;              // 0 u8, 1 u16, 2 f32
  int rows_in, lanes_in;    // extent of x
  int c;                    // channels
  int hp;                   // K7: row stride between planes
  void* out;
  int out_kind;             // 0 f32, 1 u8, 2 u16
  int out_rows, out_lanes;  // extent of out
  const __nv_bfloat16* tvh;  // [Bv, Tv, Wv]
  const __nv_bfloat16* tvl;
  const int32_t* offs_v;    // [Bv]
  int bv, tv, wv;
  const __nv_bfloat16* thh;  // [Bh, n_ch, win_c, 128] dense H taps, chunked
  const __nv_bfloat16* thl;
  const int32_t* offs_l;    // [Bh] window starts, pixels
  const int32_t* rel;       // [n_ch]
  int n_ch, win_c, th;
  const int32_t* k_range;   // [Bv, n_slices, 2] nonzero V-tap rows, 32-aligned
  int n_slices;
  const int32_t* h_range;   // [Bh, n_ch, 2] nonzero H-tap rows, 32-aligned
  int alpha_ch;             // plane / channel that bypasses the curves, or -1
  k1::Epilogue epi_in;      // K8: alpha_lane = the interleaved lane mask
  k1::Epilogue epi;         // alpha_lane = 0 when alpha_ch >= 0, else -1
};

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float widen(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// The lane handed to k1_common.cuh's alpha test for channel p: 0 is the
// alpha lane of ``epi`` (alpha_lane 0), 1 is not.
__device__ __forceinline__ int plane_lane(const Args& a, int p) {
  return p == a.alpha_ch ? 0 : 1;
}

// Channel p's element at window row r, pixel w, after the pack stage;
// zero past the input's edge.
template <bool INTERLEAVED, bool GAMMA>
__device__ __forceinline__ float load_lin(const Args& a, int p, int r, int w) {
  size_t i;
  int lane;
  if (INTERLEAVED) {
    lane = w * a.c + p;
    if (r >= a.rows_in || lane >= a.lanes_in) return 0.0f;
    i = static_cast<size_t>(r) * a.lanes_in + lane;
  } else {
    lane = plane_lane(a, p);
    if (r >= a.hp || w >= a.lanes_in) return 0.0f;
    i = static_cast<size_t>(p * a.hp + r) * a.lanes_in + w;
  }
  float v;
  if (a.in_kind == 0) {
    v = static_cast<float>(__ldg(static_cast<const uint8_t*>(a.x) + i));
  } else if (a.in_kind == 1) {
    v = static_cast<float>(__ldg(static_cast<const uint16_t*>(a.x) + i));
  } else {
    v = __ldg(static_cast<const float*>(a.x) + i);
  }
  if (!GAMMA) return v;
  return k1::gamma_in(INTERLEAVED ? a.epi_in : a.epi, v, lane);
}

template <bool INTERLEAVED, bool GAMMA>
__device__ __forceinline__ void store_out(const Args& a, int p, int vb, int r0, int hb,
                                          int j, const float (&acc)[4][4]) {
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int lane = plane_lane(a, p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tr = r0 + 4 * ty + i;
    if (tr >= a.tv) continue;
    const int orow = (INTERLEAVED ? 0 : p * a.bv * a.tv) + vb * a.tv + tr;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int t = j * kLanes + 4 * tx + jj;
      if (t >= a.th) continue;
      const int ocol = (INTERLEAVED ? (hb * a.c + p) : hb) * a.th + t;
      const size_t o = static_cast<size_t>(orow) * a.out_lanes + ocol;
      if (a.out_kind == 0) {
        static_cast<float*>(a.out)[o] = k1::finish_float<GAMMA>(a.epi, acc[i][jj], lane);
        continue;
      }
      const int q = static_cast<int>(k1::finish_int<GAMMA>(a.epi, acc[i][jj], lane));
      if (a.out_kind == 1) {
        static_cast<uint8_t*>(a.out)[o] = static_cast<uint8_t>(q);
      } else {
        static_cast<uint16_t*>(a.out)[o] = static_cast<uint16_t>(q);
      }
    }
  }
}

template <bool INTERLEAVED, bool S3V, bool S3H, bool GAMMA>
__global__ void __launch_bounds__(kThreads) planar_vh(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float (*svh)[kDepth] = reinterpret_cast<float (*)[kDepth]>(smem);  // V taps
  float (*svl)[kDepth] = svh + kRows;
  // x tile [32 rows][128 pixels] in the V pass, H taps [32][128] in the H pass.
  float (*sah)[kLanes] = reinterpret_cast<float (*)[kLanes]>(smem + 2 * kRows * kDepth);
  float (*sal)[kLanes] = sah + kDepth;
  float (*sih)[kLanes] = sal + kDepth;  // intermediate [32 rows][128 pixels]
  float (*sil)[kLanes] = sih + kRows;

  const int chunk = blockIdx.x;
  const int hb = chunk / a.n_ch, j = chunk % a.n_ch;
  const int vb = blockIdx.y / a.n_slices, sl = blockIdx.y % a.n_slices;
  const int p = blockIdx.z;
  const int r0 = sl * kRows;
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
  const int k_lo = a.k_range[2 * blockIdx.y];
  const int k_hi = a.k_range[2 * blockIdx.y + 1];
  const int h_lo = a.h_range[2 * chunk] / kLanes * kLanes;
  const int h_hi = a.h_range[2 * chunk + 1];
  const int row0 = a.offs_v[vb];
  const int px0 = a.offs_l[hb] + a.rel[j];

  float acc[4][4] = {};
  for (int seg = h_lo; seg < h_hi; seg += kLanes) {
    // ---- V pass over this 128-pixel segment --------------------------
    float m[4][4] = {};
    for (int k0 = k_lo; k0 < k_hi; k0 += kDepth) {
      __syncthreads();
      for (int e = tid; e < kRows * kDepth; e += kThreads) {
        const int r = e / kDepth, k = e % kDepth;
        const int tr = r0 + r;
        float h = 0.0f, l = 0.0f;
        if (tr < a.tv) {
          const size_t off = (static_cast<size_t>(vb) * a.tv + tr) * a.wv + k0 + k;
          h = widen(a.tvh, off);
          l = widen(a.tvl, off);
        }
        svh[r][k] = h;
        svl[r][k] = l;
      }
      for (int e = tid; e < kDepth * kLanes; e += kThreads) {
        const int k = e / kLanes, l = e % kLanes;
        const float v = load_lin<INTERLEAVED, GAMMA>(a, p, row0 + k0 + k, px0 + seg + l);
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
    // ---- split the intermediate into shared memory -------------------
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
    // ---- H pass (dense taps): this segment's share -------------------
    for (int l0 = 0; l0 < kLanes; l0 += kDepth) {
      __syncthreads();
      const size_t base = (static_cast<size_t>(chunk) * a.win_c + seg + l0) * kLanes;
      for (int e = tid; e < kDepth * kLanes; e += kThreads) {
        sah[e / kLanes][e % kLanes] = widen(a.thh, base + e);
        sal[e / kLanes][e % kLanes] = widen(a.thl, base + e);
      }
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
  store_out<INTERLEAVED, GAMMA>(a, p, vb, r0, hb, j, acc);
}

constexpr size_t kSmem = (2 * kRows * kDepth + 2 * kDepth * kLanes + 2 * kRows * kLanes) * sizeof(float);

template <bool INTERLEAVED, bool S3V, bool S3H, bool GAMMA>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(planar_vh<INTERLEAVED, S3V, S3H, GAMMA>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(kSmem));
  if (e != cudaSuccess) return e;
  planar_vh<INTERLEAVED, S3V, S3H, GAMMA><<<grid, kThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}

template <bool INTERLEAVED, bool GAMMA>
cudaError_t launch_modes(bool s3v, bool s3h, const Args& a, dim3 grid, cudaStream_t s) {
  if (s3v) {
    return s3h ? launch<INTERLEAVED, true, true, GAMMA>(a, grid, s)
               : launch<INTERLEAVED, true, false, GAMMA>(a, grid, s);
  }
  return s3h ? launch<INTERLEAVED, false, true, GAMMA>(a, grid, s)
             : launch<INTERLEAVED, false, false, GAMMA>(a, grid, s);
}

}  // namespace

extern "C" int avir_planar(
    int interleaved, int split3_v, int split3_h,
    int in_kind, int out_kind,
    const void* x, int rows_in, int lanes_in, int c, int hp,
    void* out, int out_rows, int out_lanes,
    const void* tvh, const void* tvl, const void* offs_v,
    int bv, int tv, int wv,
    const void* thh, const void* thl, const void* offs_l, const void* rel,
    int bh, int n_ch, int win_c, int th,
    const void* k_range, int n_slices, const void* h_range,
    float out_max, float tm, int trunc_bits,
    int gamma, int alpha_ch, int alpha_lane_in, float in_gamma_mult, float out_gamma_mult,
    float scale, int even,
    void* stream) {
  Args a;
  a.x = x;
  a.in_kind = in_kind;
  a.rows_in = rows_in;
  a.lanes_in = lanes_in;
  a.c = c;
  a.hp = hp;
  a.out = out;
  a.out_kind = out_kind;
  a.out_rows = out_rows;
  a.out_lanes = out_lanes;
  a.tvh = static_cast<const __nv_bfloat16*>(tvh);
  a.tvl = static_cast<const __nv_bfloat16*>(tvl);
  a.offs_v = static_cast<const int32_t*>(offs_v);
  a.bv = bv;
  a.tv = tv;
  a.wv = wv;
  a.thh = static_cast<const __nv_bfloat16*>(thh);
  a.thl = static_cast<const __nv_bfloat16*>(thl);
  a.offs_l = static_cast<const int32_t*>(offs_l);
  a.rel = static_cast<const int32_t*>(rel);
  a.n_ch = n_ch;
  a.win_c = win_c;
  a.th = th;
  a.k_range = static_cast<const int32_t*>(k_range);
  a.n_slices = n_slices;
  a.h_range = static_cast<const int32_t*>(h_range);
  a.alpha_ch = alpha_ch;
  a.epi.alpha_lane = alpha_ch >= 0 ? 0 : -1;
  a.epi.in_gamma_mult = in_gamma_mult;
  a.epi.out_gamma_mult = out_gamma_mult;
  a.epi.scale = scale;
  a.epi.even = even;
  a.epi.trunc_bits = trunc_bits;
  a.epi.tm = tm;
  a.epi.out_max = out_max;
  a.epi_in = a.epi;
  a.epi_in.alpha_lane = alpha_lane_in;
  const dim3 grid(bh * n_ch, bv * n_slices, c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (interleaved) {
    e = gamma ? launch_modes<true, true>(split3_v, split3_h, a, grid, s)
              : launch_modes<true, false>(split3_v, split3_h, a, grid, s);
  } else {
    e = gamma ? launch_modes<false, true>(split3_v, split3_h, a, grid, s)
              : launch_modes<false, false>(split3_v, split3_h, a, grid, s);
  }
  return static_cast<int>(e);
}
