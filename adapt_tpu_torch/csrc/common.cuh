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
#include <type_traits>

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

// cp.async: 16-byte (or 4-byte) copies from device memory into shared
// memory that run while the thread goes on; `in` false copies nothing and
// zero-fills the destination. cp_wait<N> returns once at most N of this
// thread's committed groups are still in flight.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Raw staging, for the kernels that copy a cached vector's bytes as the
// cache holds them (decode_cluster.cuh): each policy below names its value
// bytes per vector (kRowBytes, a multiple of 16) and how the HD / 8 lanes
// of one vector read it back from a staged row, 8 elements a lane,
// converted in registers. Lane `li` holds columns col8(li, 0..7): for
// 16-bit, int8 and int4 values the 8 consecutive columns li * 8.., one
// 16-, 8- or 4-byte shared load; for f32 two 16-byte loads, columns
// li * 4.. and HD / 2 + li * 4.., so the 8 lanes of a quarter-warp read
// 128 consecutive bytes in each.
template <typename T, int HD>
__device__ __forceinline__ void unpack8_native(const unsigned char* row,
                                               int li, float x[8]) {
  if constexpr (std::is_same<T, float>::value) {
    const float4 a = *reinterpret_cast<const float4*>(row + li * 16);
    const float4 b = *reinterpret_cast<const float4*>(row + HD * 2 + li * 16);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(row + li * 16);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        const float2 f =
            __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
      }
    }
  }
}

// Byte k (0..3) of a 32-bit word as a signed value.
__device__ __forceinline__ int sbyte(uint32_t w, int k) {
  return static_cast<int>(w << (24 - 8 * k)) >> 24;
}

// Cache-element policies: how a kernel stages `N` consecutive columns,
// from column c0, of cached vector `vec` (the vector's index in the K/V
// buffers) into f32 shared memory, and where a vector's scale lives. K4's
// f32 page walk produces `vec`; the policy turns it into a value address
// (vec * the value width) and a scale address (vec itself), so one kernel
// body serves every cache dtype. `in` false stages zeros (and a zero
// scale).

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
  // raw staging
  static constexpr int kRowBytes = HD * (int)sizeof(T);
  static constexpr int kHeadDim = HD;
  __device__ __forceinline__ const void* k_raw() const { return k; }
  __device__ __forceinline__ const void* v_raw() const { return v; }
  __device__ __forceinline__ static void unpack8(const unsigned char* row,
                                                 int li, float x[8]) {
    unpack8_native<T, HD>(row, li, x);
  }
  __host__ __device__ static constexpr int col8(int li, int e) {
    return sizeof(T) == 4 ? (e < 4 ? li * 4 + e : HD / 2 + li * 4 + e - 4)
                          : li * 8 + e;
  }
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
  // raw staging: 8 int8 values a lane, one 8-byte load
  static constexpr int kRowBytes = HD;
  static constexpr int kHeadDim = HD;
  __device__ __forceinline__ const void* k_raw() const { return k; }
  __device__ __forceinline__ const void* v_raw() const { return v; }
  __device__ __forceinline__ static void unpack8(const unsigned char* row,
                                                 int li, float x[8]) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + li * 8);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = (float)sbyte(u.x, k);
      x[4 + k] = (float)sbyte(u.y, k);
    }
  }
  __host__ __device__ static constexpr int col8(int li, int e) {
    return li * 8 + e;
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
  // raw staging: 4 packed bytes (8 values) a lane, one 4-byte load
  static constexpr int kRowBytes = HD / 2;
  static constexpr int kHeadDim = HD;
  __device__ __forceinline__ const void* k_raw() const { return k; }
  __device__ __forceinline__ const void* v_raw() const { return v; }
  __device__ __forceinline__ static void unpack8(const unsigned char* row,
                                                 int li, float x[8]) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(row + li * 4);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = sbyte(u, k);
      x[2 * k] = (float)(((b & 15) ^ 8) - 8);
      x[2 * k + 1] = (float)(b >> 4);
    }
  }
  __host__ __device__ static constexpr int col8(int li, int e) {
    return li * 8 + e;
  }
};

// Stages the raw bytes of TK cached vectors of K (V = false) or V (V =
// true) into `dst`: TK rows of kRowBytes, as the cache holds them, then for
// a scaled cache the TK scales. vec[r] is key r's vector index, or -1 for a
// key that is not staged: its bytes and scale are zero-filled and nothing
// is read. 16-byte cp.async copies, neighbouring threads on neighbouring
// chunks; 4-byte ones for the scales (a scale row of a dense strip of odd
// length is not 16-byte aligned). All NT threads call it; the caller
// commits and waits.
template <int NT, int TK, bool V, typename KV>
__device__ __forceinline__ void stage_raw(const KV& kv, const long long* vec,
                                          unsigned char* dst) {
  constexpr int RB = KV::kRowBytes, CPK = RB / 16;
  static_assert(RB % 16 == 0, "a cached vector is whole 16-byte chunks");
  const unsigned char* base =
      static_cast<const unsigned char*>(V ? kv.v_raw() : kv.k_raw());
  const uint32_t d0 = smem_addr(dst);
  for (int i = threadIdx.x; i < TK * CPK; i += NT) {
    const long long x = vec[i / CPK];
    const bool in = x >= 0;
    cp_async16(d0 + i * 16, base + (in ? x * RB + (i % CPK) * 16 : 0), in);
  }
  if constexpr (KV::kScaled) {
    for (int i = threadIdx.x; i < TK; i += NT) {
      const long long x = vec[i];
      const bool in = x >= 0;
      cp_async4(d0 + TK * RB + i * 4, (V ? kv.vs : kv.ks) + (in ? x : 0),
                in);
    }
  }
}

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
