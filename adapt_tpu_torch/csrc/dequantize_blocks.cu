// K6-dequantize: the inverse of blockwise int8 quantization for Hopper
// (sm_90a).
//
// Replaces the TPU kernel adapt_tpu/ops/quantize.py:_dequant_kernel (reached
// through `dequantize`): element i of the output is int8 value i times the
// f32 scale of its 8192-element block, cut to the tensor's logical size.
//
// Design. One thread block per quantization block, as in
// quantize_blocks.cu; the product is formed in f32 and written straight in
// the target dtype (one rounding - the same value as the TPU package's f32
// result followed by its cast), so no f32 copy of the tensor and no padded
// tail ever exist in device memory.
//
// Bound. Reads n bytes and writes n elements once: bytes bound.
#include "common.cuh"

namespace adapt {
namespace quant {

constexpr int BLOCK = 64 * 128;
constexpr int NT = 256;

template <typename T>
__global__ void __launch_bounds__(NT)
    dequantize_kernel(const int8_t* __restrict__ vals,
                      const float* __restrict__ scales, T* __restrict__ out,
                      long long n) {
  const float s = scales[blockIdx.x];
  const long long base = (long long)blockIdx.x * BLOCK;
#pragma unroll 8
  for (int i = threadIdx.x; i < BLOCK; i += NT) {
    const long long e = base + i;
    if (e < n) out[e] = from_f<T>(__fmul_rn((float)vals[e], s));
  }
}

template <typename T>
int launch(const int8_t* vals, const float* scales, void* out, long long n,
           cudaStream_t st) {
  const int num_blocks = (int)((n + BLOCK - 1) / BLOCK);
  dequantize_kernel<T><<<num_blocks, NT, 0, st>>>(vals, scales,
                                                  static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace quant
}  // namespace adapt

// vals: at least n int8; scales: ceil(n / 8192) f32; out: n elements of
// `dtype`.
extern "C" int dequantize_blocks(const void* vals, const float* scales,
                                 void* out, long long n, int dtype,
                                 void* stream) {
  using namespace adapt;
  if (n < 1) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const int8_t*>(vals);
  switch (dtype) {
    case kF32:
      return quant::launch<float>(v, scales, out, n, st);
    case kBF16:
      return quant::launch<__nv_bfloat16>(v, scales, out, n, st);
    case kF16:
      return quant::launch<__half>(v, scales, out, n, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
