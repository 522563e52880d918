// Shared helpers of the port's CUDA kernels: element conversion and
// 16-byte vector loads for bf16 / fp32 tensors.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vyomai {

// torch.finfo(float32).min, the additive mask constant of the JAX package
constexpr float kNegInf = -3.4028234663852886e38f;
// floor of the running max: a fully-masked row keeps exp(masked - m) == 0
constexpr float kMaxFloor = -1e30f;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<
    __nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Elements of T in one 16-byte vector.
template <typename T> struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

// Load 16 bytes (Vec<T>::kN elements) at an aligned address into floats.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* elems = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < Vec<T>::kN; ++e) dst[e] = to_float<T>(elems[e]);
}

}  // namespace vyomai
