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

#include <cstddef>
#include <cstdint>

namespace adapt {

// The finite masking sentinel of the JAX kernels (ops/attention.py and
// ops/decode_attention.py `_NEG_INF`): a partly masked live tile adds
// exp(0) garbage that a later live key washes out, exactly as there.
constexpr float kNegInf = -1e30f;

// dtype codes shared with ops/_build.py
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// KV cache element codes shared with ops/_build.py: K/V in the query's
// dtype, int8 values with one f32 scale per vector, or int4 values packed
// two per byte with one f32 scale per vector.
enum KVCode { kKVNative = 0, kKVInt8 = 1, kKVInt4 = 2 };

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

// Cache-element policies: how a kernel stages `N` consecutive columns,
// from column c0, of cached vector `vec` (the vector's index in the K/V
// buffers) into f32 shared memory, and where a vector's scale lives. The
// address functors of decode_tile.cuh and K4's page walk produce `vec`;
// the policy turns it into a value address (vec * the value width) and a
// scale address (vec itself), so one kernel body serves every layout and
// every cache dtype. `in` false stages zeros (and a zero scale).

// K/V in the query's type: the scale is 1 and never applied.
template <typename T, int HD>
struct NativeKV {
  static constexpr bool kScaled = false;
  const T* k;
  const T* v;
  template <int N>
  __device__ __forceinline__ void stage(bool in, size_t vec, int c0,
                                        float* kd, float* vd) const {
    const size_t a = in ? vec * HD + c0 : 0;
#pragma unroll 8
    for (int c = 0; c < N; ++c) {
      kd[c] = in ? to_f(k[a + c]) : 0.f;
      vd[c] = in ? to_f(v[a + c]) : 0.f;
    }
  }
  __device__ __forceinline__ float k_scale(bool, size_t) const { return 1.f; }
  __device__ __forceinline__ float v_scale(bool, size_t) const { return 1.f; }
};

// int8 values, HD per vector, and one f32 scale per vector.
template <int HD>
struct Int8KV {
  static constexpr bool kScaled = true;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  template <int N>
  __device__ __forceinline__ void stage(bool in, size_t vec, int c0,
                                        float* kd, float* vd) const {
    const size_t a = in ? vec * HD + c0 : 0;
#pragma unroll 8
    for (int c = 0; c < N; ++c) {
      kd[c] = in ? (float)k[a + c] : 0.f;
      vd[c] = in ? (float)v[a + c] : 0.f;
    }
  }
  __device__ __forceinline__ float k_scale(bool in, size_t vec) const {
    return in ? ks[vec] : 0.f;
  }
  __device__ __forceinline__ float v_scale(bool in, size_t vec) const {
    return in ? vs[vec] : 0.f;
  }
};

// int4 values packed two per byte, HD / 2 bytes per vector: element 2i is
// the low nibble of byte i (sign-extended as ((b & 15) ^ 8) - 8), element
// 2i + 1 the high nibble (an arithmetic shift of the signed byte). Unpacked
// in registers, so device memory streams the 4-bit bytes. c0 and N are
// even (the staging splits head_dim into even runs).
template <int HD>
struct Int4KV {
  static constexpr bool kScaled = true;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  template <int N>
  __device__ __forceinline__ void stage(bool in, size_t vec, int c0,
                                        float* kd, float* vd) const {
    static_assert(N % 2 == 0, "int4 staging runs are whole bytes");
    const size_t a = in ? vec * (HD / 2) + c0 / 2 : 0;
#pragma unroll 8
    for (int c = 0; c < N / 2; ++c) {
      const int bk = in ? (int)k[a + c] : 0;
      const int bv = in ? (int)v[a + c] : 0;
      kd[2 * c] = (float)(((bk & 15) ^ 8) - 8);
      kd[2 * c + 1] = (float)(bk >> 4);
      vd[2 * c] = (float)(((bv & 15) ^ 8) - 8);
      vd[2 * c + 1] = (float)(bv >> 4);
    }
  }
  __device__ __forceinline__ float k_scale(bool in, size_t vec) const {
    return in ? ks[vec] : 0.f;
  }
  __device__ __forceinline__ float v_scale(bool in, size_t vec) const {
    return in ? vs[vec] : 0.f;
  }
};

// Calls `f(policy)` with the cache-element policy of `kv` over the K/V
// pointers (k/v values, ks/vs scales); returns cudaErrorInvalidValue for an
// unknown code. The head dim is a template argument of every policy.
template <typename T, int HD, typename F>
int with_kv(int kv, const void* k, const void* v, const float* ks,
            const float* vs, F f) {
  switch (kv) {
    case kKVNative:
      return f(NativeKV<T, HD>{static_cast<const T*>(k),
                               static_cast<const T*>(v)});
    case kKVInt8:
      if (ks == nullptr || vs == nullptr) return (int)cudaErrorInvalidValue;
      return f(Int8KV<HD>{static_cast<const int8_t*>(k),
                          static_cast<const int8_t*>(v), ks, vs});
    case kKVInt4:
      if (ks == nullptr || vs == nullptr) return (int)cudaErrorInvalidValue;
      return f(Int4KV<HD>{static_cast<const int8_t*>(k),
                          static_cast<const int8_t*>(v), ks, vs});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace adapt
