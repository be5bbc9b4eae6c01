// K6-quantize: blockwise int8 quantization of a tensor for Hopper (sm_90a).
//
// Replaces the TPU kernel adapt_tpu/ops/quantize.py:_quant_kernel (reached
// through `quantize`): the flattened tensor is cut into quantization blocks
// of 64 * 128 = 8192 elements; each block gets one f32 scale
// max(absmax, 1e-12) / 127 and its values are
// clip(round(x / scale), -127, 127) as int8.
//
// Design. One thread block per quantization block, 256 threads holding 32
// elements each in registers: one read of the input, in its own dtype
// (f32 / bf16 / f16, widened exactly), no padded copy in device memory - the
// ragged tail reads as zeros, and the padded tail of the value array is
// written as zeros, so the payload keeps the (rows, 128) shape the TPU
// package gives it. The absmax reduction is order-free, so it is exact
// whatever the tree. The result must be bit-equal to the plain version
// (ops/quantize.quantize_reference): the division is a true IEEE division
// (never x * (1 / scale); the build has no --use_fast_math), and rounding is
// half to even (rintf).
//
// Bound. Reads n elements once and writes n bytes plus one scale per block:
// bytes bound.
#include "common.cuh"

namespace adapt {
namespace quant {

constexpr int BLOCK = 64 * 128;  // elements per scale
constexpr int NT = 256;
constexpr int PER = BLOCK / NT;  // 32 elements per thread

template <typename T>
__global__ void __launch_bounds__(NT)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ vals,
                    float* __restrict__ scales, long long n) {
  __shared__ float red[NT / 32];
  __shared__ float scale_s;
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * BLOCK;
  float v[PER];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const long long e = base + tid + i * NT;  // coalesced
    v[i] = e < n ? to_f(x[e]) : 0.f;
    amax = fmaxf(amax, fabsf(v[i]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (tid % 32 == 0) red[tid / 32] = amax;
  __syncthreads();
  if (tid == 0) {
    float a = red[0];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) a = fmaxf(a, red[w]);
    const float s = __fdiv_rn(fmaxf(a, 1e-12f), 127.0f);
    scale_s = s;
    scales[blockIdx.x] = s;
  }
  __syncthreads();
  const float s = scale_s;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v[i], s)), -127.f), 127.f);
    vals[base + tid + i * NT] = (int8_t)q;
  }
}

template <typename T>
int launch(const void* x, int8_t* vals, float* scales, long long n,
           int num_blocks, cudaStream_t st) {
  quantize_kernel<T><<<num_blocks, NT, 0, st>>>(static_cast<const T*>(x),
                                                vals, scales, n);
  return (int)cudaGetLastError();
}

}  // namespace quant
}  // namespace adapt

// x: n elements of `dtype`; vals: num_blocks * 8192 int8; scales: num_blocks
// f32. num_blocks = ceil(n / 8192).
extern "C" int quantize_blocks(const void* x, void* vals, float* scales,
                               long long n, int num_blocks, int dtype,
                               void* stream) {
  using namespace adapt;
  if (n < 1 || (long long)num_blocks * quant::BLOCK < n)
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
