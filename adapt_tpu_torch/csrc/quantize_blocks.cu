// K6-quantize: blockwise int8 quantization of a tensor for Hopper (sm_90a).
//
// Replaces the TPU kernel adapt_tpu/ops/quantize.py:_quant_kernel (reached
// through `quantize`): the flattened tensor is cut into quantization blocks
// of 64 * 128 = 8192 elements; each block gets one f32 scale
// max(absmax, 1e-12) / 127 and its values are
// clip(round(x / scale), -127, 127) as int8.
//
// Design. A thread-block cluster of 4 CTAs per quantization block (1152
// CTAs for a 768 x 3072 matrix, where one CTA a block gave 288 on 132 SMs).
// Each CTA holds a quarter of the block, 2048 elements, in registers: each
// warp a span of 512 read with 16-byte loads in the input's own dtype (two
// a thread for bf16 / f16, four for f32; read-only, no L1 allocation; each
// warp instruction one contiguous 512 bytes), widened exactly. It reduces
// its partial absmax (warp shuffles, then 4 warps through shared memory),
// the cluster barrier publishes it, and every CTA reads the four partials
// through distributed shared memory and forms the same scale (the max is
// order-free). Rank 0 writes the scale; each warp passes its int8 values
// through shared memory so that each thread writes 16 consecutive ones as
// one 16-byte store, then waits on the second half of a split cluster
// barrier so no CTA leaves while another may still read its partial. No
// padded copy exists in device memory: the ragged tail reads as zeros and
// the padded tail of the value array is written as zeros, so the payload
// keeps the (rows, 128) shape the TPU package gives it.
//
// Bits. The result is bit-equal to the plain version
// (ops/quantize.quantize_reference): the division is a true IEEE division
// (__fdiv_rn, never x * (1 / scale); the build has no --use_fast_math) and
// rounding is half to even (rintf). Non-finite input follows the JAX
// package: every max propagates NaN (PTX max.NaN), so a block holding a NaN
// gets a NaN scale and one holding +-Inf an Inf scale, and a NaN quotient
// (a NaN element, or +-Inf / Inf) stores 0 where the clamp would have made
// it -127.
//
// Bound. Reads n elements once and writes n bytes plus one scale per block:
// bytes bound.
#include <cooperative_groups.h>

#include "common.cuh"

namespace adapt {
namespace quant {

namespace cg = cooperative_groups;

constexpr int kBlock = 64 * 128;  // elements per scale
constexpr int kCluster = 4;       // CTAs per quantization block
constexpr int kThreads = 128;
constexpr int kVec = 16;  // elements a thread
static_assert(kCluster * kThreads * kVec == kBlock, "a cluster is a block");

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ uint4 load_stream16(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// A warp's span of 512 elements from `base`: load l (l < 16 / kPer) of
// lane `lane` reads the kPer elements at base + (32 l + lane) kPer with one
// 16-byte load, so each warp instruction reads one contiguous 512 bytes.
// Elements at or past n read 0.
template <typename T>
__device__ __forceinline__ void load_span(const T* x, long long base,
                                          long long n, int lane,
                                          float (&v)[kVec]) {
  constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte load
#pragma unroll
  for (int l = 0; l < kVec / kPer; ++l) {
    const long long e = base + (32 * l + lane) * kPer;
    if (e + kPer <= n) {
      const uint4 r = load_stream16(x + e);
      const T* h = reinterpret_cast<const T*>(&r);
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[l * kPer + i] = to_f(h[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        v[l * kPer + i] = e + i < n ? to_f(x[e + i]) : 0.f;
    }
  }
}

template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ vals,
                    float* __restrict__ scales, long long n) {
  constexpr int kPer = 16 / sizeof(T);
  __shared__ float warp_max[kThreads / 32];
  __shared__ float part;  // this CTA's absmax, read by the whole cluster
  __shared__ uint4 stage[kThreads];  // the int8 values, 16 a thread
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long blk = blockIdx.x / kCluster;
  const long long span = blk * kBlock + (long long)(rank * kThreads +
                                                    warp * 32) * kVec;
  float v[kVec];
  load_span(x, span, n, lane, v);
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) a = max_nan(a, fabsf(v[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    a = max_nan(a, __shfl_xor_sync(0xffffffffu, a, o));
  if (lane == 0) warp_max[warp] = a;
  __syncthreads();
  if (tid == 0) {
    float p = warp_max[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) p = max_nan(p, warp_max[w]);
    part = p;
  }
  cluster.sync();  // every rank has started and published its partial
  float amax = *cluster.map_shared_rank(&part, 0);
#pragma unroll
  for (int r = 1; r < kCluster; ++r)
    amax = max_nan(amax, *cluster.map_shared_rank(&part, r));
  // First half of a split cluster barrier: this CTA is done reading the
  // partials; the wait below keeps each CTA's shared memory alive until
  // every rank has read it.
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  const float s = __fdiv_rn(max_nan(amax, 1e-12f), 127.0f);
  if (rank == 0 && tid == 0) scales[blk] = s;
  // Quantize; load l's kPer values go to bytes (32 l + lane) kPer of the
  // warp's 512 in shared memory, and each lane stores 16 of them.
  int8_t* st = reinterpret_cast<int8_t*>(&stage[warp * 32]);
#pragma unroll
  for (int l = 0; l < kVec / kPer; ++l) {
    uint32_t w[kPer / 4];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float r = rintf(__fdiv_rn(v[l * kPer + i], s));
      const int q = r != r ? 0 : (int)fminf(fmaxf(r, -127.f), 127.f);
      if (i % 4 == 0) w[i / 4] = 0u;
      w[i / 4] |= (uint32_t)(q & 0xff) << (8 * (i % 4));
    }
    int8_t* d = st + (32 * l + lane) * kPer;
    if constexpr (kPer == 8)
      *reinterpret_cast<uint2*>(d) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(d) = w[0];
  }
  __syncwarp();
  *reinterpret_cast<uint4*>(vals + span + lane * kVec) = stage[tid];
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T>
int launch(const void* x, int8_t* vals, float* scales, long long n,
           int num_blocks, cudaStream_t st) {
  quantize_kernel<T><<<num_blocks * kCluster, kThreads, 0, st>>>(
      static_cast<const T*>(x), vals, scales, n);
  return (int)cudaGetLastError();
}

}  // namespace quant
}  // namespace adapt

// x: n elements of `dtype`, 16-byte aligned; vals: num_blocks * 8192 int8
// (16-byte aligned); scales: num_blocks f32. num_blocks = ceil(n / 8192).
extern "C" int quantize_blocks(const void* x, void* vals, float* scales,
                               long long n, int num_blocks, int dtype,
                               void* stream) {
  using namespace adapt;
  if (n < 1 || (long long)num_blocks * quant::kBlock < n ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(vals) % 16)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto v = static_cast<int8_t*>(vals);
  switch (dtype) {
    case kF32:
      return quant::launch<float>(x, v, scales, n, num_blocks, st);
    case kBF16:
      return quant::launch<__nv_bfloat16>(x, v, scales, n, num_blocks, st);
    case kF16:
      return quant::launch<__half>(x, v, scales, n, num_blocks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
