// Element-type helpers shared by the port's kernels. Every kernel is
// templated over `float` and `__nv_bfloat16`, computes in fp32, and
// converts only through these intrinsics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wt {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
// Round to nearest even, as jnp's astype(bfloat16) does.
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// Round an fp32 value through the storage type T and back: reproduces the
// points where the JAX block stores an intermediate in the compute dtype.
// The identity for T = float.
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f32<T>(from_f32<T>(x));
}

}  // namespace wt
