// Shared helpers for the hand-written Hopper kernels of adapt_tpu_torch.
//
// Every kernel is exported through a plain C function (bound with ctypes,
// no PyTorch headers) that launches on the caller's stream and returns
// cudaGetLastError() right after the launch, so a refused launch (too much
// shared memory, a bad grid) reaches the Python wrapper as a non-zero code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace adapt {

// The finite masking sentinel of the JAX kernels (ops/attention.py and
// ops/decode_attention.py `_NEG_INF`): a partly masked live tile adds
// exp(0) garbage that a later live key washes out, exactly as there.
constexpr float kNegInf = -1e30f;

// dtype codes shared with ops/_build.py
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

}  // namespace adapt
