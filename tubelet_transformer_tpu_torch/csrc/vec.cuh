// 16-byte vectors of a channels-last tensor, as the backbone kernels
// (depthwise.cu, bottleneck.cu) load and store them: 8 bf16 or 4 float
// channels in one uint4, unpacked to float for the arithmetic and packed
// back with one rounding.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace tuber {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(&u);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    const float4 v = make_float4(f[0], f[1], f[2], f[3]);
    return *reinterpret_cast<const uint4*>(&v);
  }
};

__device__ __forceinline__ uint4 zero_vec() { return make_uint4(0, 0, 0, 0); }

template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const uint4& u) {
  *reinterpret_cast<uint4*>(p) = u;
}

// ReLU that keeps a NaN, as torch's relu does
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

}  // namespace tuber
