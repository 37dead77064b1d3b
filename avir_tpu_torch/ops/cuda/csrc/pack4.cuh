// Four image elements of one row, packed as loaded, for the bf16
// tensor-core kernels that convert and split the image as they stage it
// (fused_split.cu, planar.cu): u8 in a 32-bit word, u16 in two, f32 in
// four.  ``load`` reads four consecutive elements with one vector load
// (16-byte row alignment and 4 in range), ``gather`` the first n of four
// elements ``stride`` apart one by one (the rest 0), ``get`` converts
// element e to f32.

#pragma once

#include <cstdint>

template <typename T>
struct Pack4;

template <>
struct Pack4<uint8_t> {
  using type = uint32_t;
  __device__ static type load(const uint8_t* p) { return __ldg(reinterpret_cast<const uint32_t*>(p)); }
  __device__ static type gather(const uint8_t* p, int n, int stride = 1) {
    uint32_t v = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < n) v |= static_cast<uint32_t>(__ldg(p + e * stride)) << (8 * e);
    }
    return v;
  }
  __device__ static float get(type v, int e) { return static_cast<float>((v >> (8 * e)) & 0xffu); }
};

template <>
struct Pack4<uint16_t> {
  using type = uint2;
  __device__ static type load(const uint16_t* p) { return __ldg(reinterpret_cast<const uint2*>(p)); }
  __device__ static type gather(const uint16_t* p, int n, int stride = 1) {
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < n) w[e / 2] |= static_cast<uint32_t>(__ldg(p + e * stride)) << (16 * (e % 2));
    }
    return make_uint2(w[0], w[1]);
  }
  __device__ static float get(type v, int e) {
    const uint32_t w = e < 2 ? v.x : v.y;
    return static_cast<float>((w >> (16 * (e % 2))) & 0xffffu);
  }
};

template <>
struct Pack4<float> {
  using type = float4;
  __device__ static type load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static type gather(const float* p, int n, int stride = 1) {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < n) v[e] = __ldg(p + e * stride);
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float get(type v, int e) { return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w; }
};
