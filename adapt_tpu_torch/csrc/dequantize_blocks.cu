// K6-dequantize: the inverse of blockwise int8 quantization for Hopper
// (sm_90a).
//
// Replaces the TPU kernel adapt_tpu/ops/quantize.py:_dequant_kernel (reached
// through `dequantize`, one pallas_call per leaf): element i of the output
// is int8 value i times the f32 scale of its 8192-element block, cut to the
// tensor's logical size, in the tensor's dtype.
//
// Design. One launch dequantizes a TABLE of up to 32 leaves (a draft's
// whole weight tree: ops/quantize.dequantize_params), passed by value as a
// kernel parameter (__grid_constant__), so the host copies nothing to the
// device. Each leaf is cut into chunks of kChunk elements; chunk prefix
// sums say which leaf CTA c works on (a chunk never straddles two leaves,
// so the dtype branch is uniform in a CTA), and the CTAs are many and
// equal, so SMs stay evenly loaded whatever the leaves' sizes. A thread
// reads 16 consecutive int8 values with one 16-byte load (read-only, no L1
// allocation), two vectors in flight before it uses either. The products
// are formed in f32 (__fmul_rn, one scale per 512-element warp span: 512
// divides 8192) and rounded once into the target dtype (the pair
// conversions round as __float2bfloat16 / __float2half do). Outputs leave
// as 16-byte stores, each warp instruction one contiguous 512 bytes: the
// warp passes its int8 values through its own slice of shared memory, so
// the lanes that store a 16-byte piece need not be the lane that loaded
// its bytes (a thread storing its own 16 outputs wrote 16-byte pieces 32
// or 64 bytes apart and ran f32 leaves at half the byte bound). The payload
// is padded to whole blocks, so a load that starts below n stays in
// bounds; only the stores that reach past n are cut to scalars, and spans
// past n do nothing. Bases must be 16-byte aligned (the wrapper checks;
// this entry point refuses otherwise).
//
// Bound. Reads n bytes plus the scales and writes n elements once: bytes
// bound.
#include "common.cuh"

namespace adapt {
namespace dequant {

constexpr int kBlockShift = 13;  // 64 * 128 = 8192 elements a scale
constexpr int kVec = 16;         // int8 values a 16-byte load
constexpr int kThreads = 128;
constexpr int kVecsPerThread = 2;
// ops/quantize.CHUNK
constexpr int kChunk = kThreads * kVec * kVecsPerThread;
constexpr int kMaxLeaves = 32;  // ops/quantize.MAX_LEAVES

struct Leaf {
  const int8_t* vals;
  const float* scales;
  void* out;
  long long n;
  int dtype;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int first[kMaxLeaves + 1];  // chunk prefix sums: leaf j owns
                              // [first[j], first[j + 1])
  int count;
};

__device__ __forceinline__ uint4 load_stream16(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ uint32_t pack2(float a, float b, __nv_bfloat16) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack2(float a, float b, __half) {
  __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The pair conversions round as __float2bfloat16 / __float2half do.
template <typename T>
__device__ __forceinline__ uint4 convert8(uint2 raw, float s) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = i < 2 ? raw.x : raw.y;
    const int sh = 16 * (i % 2);
    w[i] = pack2(__fmul_rn((float)(int8_t)(b >> sh), s),
                 __fmul_rn((float)(int8_t)(b >> (sh + 8)), s), T());
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float4 convert4(uint32_t raw, float s) {
  return make_float4(__fmul_rn((float)(int8_t)raw, s),
                     __fmul_rn((float)(int8_t)(raw >> 8), s),
                     __fmul_rn((float)(int8_t)(raw >> 16), s),
                     __fmul_rn((float)(int8_t)(raw >> 24), s));
}

// This CTA's chunk of leaf L, from element e0. Each warp owns spans of
// 512 elements (32 threads x 16): it loads a span's int8 values as one
// 16-byte vector a thread, passes them through its own slice of shared
// memory, and writes the span's outputs as sizeof(T) rounds of 16-byte
// stores, round r covering bytes [512 r, 512 r + 512) of the span's output
// - every store instruction one contiguous 512 bytes. 512 divides 8192, so
// a span has one scale.
template <typename T>
__device__ __forceinline__ void dequant_chunk(const Leaf& L, long long e0,
                                              uint4 (&stage)[kVecsPerThread]
                                                            [kThreads]) {
  constexpr int kPer = 16 / sizeof(T);  // outputs a 16-byte store
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  long long e[kVecsPerThread];
  uint4 raw[kVecsPerThread];
  float sc[kVecsPerThread];
  // Every load of the chunk, the scales too, is in flight before any is
  // used: a scale read after the values added a second memory latency (on
  // an H100, a 2-layer GPT-2 draft's tree took 0.134 ms against 0.132).
#pragma unroll
  for (int u = 0; u < kVecsPerThread; ++u) {
    e[u] = e0 + (long long)(u * kThreads + threadIdx.x) * kVec;
    const long long span = e0 + (long long)(u * kThreads + warp * 32) * kVec;
    if (e[u] < L.n) raw[u] = load_stream16(L.vals + e[u]);
    if (span < L.n) sc[u] = __ldg(L.scales + (span >> kBlockShift));
  }
#pragma unroll
  for (int u = 0; u < kVecsPerThread; ++u)
    if (e[u] < L.n) stage[u][threadIdx.x] = raw[u];
  __syncwarp();
  T* out = static_cast<T*>(L.out);
#pragma unroll
  for (int u = 0; u < kVecsPerThread; ++u) {
    const long long span = e0 + (long long)(u * kThreads + warp * 32) * kVec;
    if (span >= L.n) continue;  // uniform in the warp
    const float s = sc[u];
    const int8_t* v = reinterpret_cast<const int8_t*>(&stage[u][warp * 32]);
#pragma unroll
    for (int r = 0; r < (int)sizeof(T); ++r) {
      const int p = (r * 32 + lane) * kPer;  // element in the span
      const long long left = L.n - (span + p);
      if (left <= 0) continue;
      T* o = out + span + p;
      if constexpr (std::is_same_v<T, float>) {
        const float4 f = convert4(*reinterpret_cast<const uint32_t*>(v + p),
                                  s);
        if (left >= kPer) {
          *reinterpret_cast<float4*>(o) = f;
        } else {  // the leaf's last elements
          const float g[4] = {f.x, f.y, f.z, f.w};
          for (int i = 0; i < left; ++i) o[i] = g[i];
        }
      } else {
        const uint4 h = convert8<T>(*reinterpret_cast<const uint2*>(v + p), s);
        if (left >= kPer) {
          *reinterpret_cast<uint4*>(o) = h;
        } else {
          const T* g = reinterpret_cast<const T*>(&h);
          for (int i = 0; i < left; ++i) o[i] = g[i];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    dequantize_kernel(const __grid_constant__ Table t) {
  __shared__ uint4 stage[kVecsPerThread][kThreads];  // 4 KB
  const int c = blockIdx.x;
  int lo = 0, hi = t.count - 1;  // the leaf j with first[j] <= c
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= c)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Leaf& L = t.leaf[lo];
  const long long e0 = (long long)(c - t.first[lo]) * kChunk;
  switch (L.dtype) {
    case kF32:
      dequant_chunk<float>(L, e0, stage);
      break;
    case kBF16:
      dequant_chunk<__nv_bfloat16>(L, e0, stage);
      break;
    default:
      dequant_chunk<__half>(L, e0, stage);
      break;
  }
}

}  // namespace dequant
}  // namespace adapt

// A table of `count` (1..32) leaves, each as host arrays: vals[j] (whole
// 8192-blocks of int8 covering n[j]), scales[j] (ceil(n[j] / 8192) f32),
// outs[j] (n[j] elements of dtype[j]), and first[0..count], the chunk
// prefix sums (first[0] = 0, first[j + 1] - first[j] = ceil(n[j] / 4096)).
// One launch of first[count] CTAs.
extern "C" int dequantize_blocks(const void* const* vals,
                                 const void* const* scales,
                                 void* const* outs, const long long* n,
                                 const int* dtype, const int* first,
                                 int count, void* stream) {
  using namespace adapt;
  using namespace adapt::dequant;
  if (count < 1 || count > kMaxLeaves || first[0] != 0)
    return (int)cudaErrorInvalidValue;
  Table t;
  t.count = count;
  t.first[0] = 0;
  for (int j = 0; j < count; ++j) {
    const bool aligned = !(reinterpret_cast<uintptr_t>(vals[j]) % 16) &&
                         !(reinterpret_cast<uintptr_t>(outs[j]) % 16);
    if (n[j] < 1 || dtype[j] < kF32 || dtype[j] > kF16 || !aligned ||
        first[j + 1] - first[j] != (n[j] + kChunk - 1) / kChunk)
      return (int)cudaErrorInvalidValue;
    t.leaf[j] = Leaf{static_cast<const int8_t*>(vals[j]),
                     static_cast<const float*>(scales[j]), outs[j], n[j],
                     dtype[j]};
    t.first[j + 1] = first[j + 1];
  }
  dequantize_kernel<<<first[count], kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(t);
  return (int)cudaGetLastError();
}
