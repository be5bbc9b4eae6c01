// K2 and K2-split: one decode step of cached attention for Hopper (sm_90a).
//
// Replaces the TPU kernels adapt_tpu/ops/decode_attention.py:_decode_kernel
// (step body _attend_tile) and _decode_split_kernel for native caches: the
// group-folded query q (b, kv_h, g, hd) attends a dense per-slot cache
// (b, kv_h, L, hd) up to each row's `index`, masked below by `valid_from`,
// with an f32 online softmax. The split variant (flash decoding) cuts the
// key range into `split` parts, each emitting unnormalised partials
// (acc, m, l) that ops/decode_attention._combine_splits reduces.
//
// Design. One block per (b * kv_h) row, or per (row, split). All g folded
// query rows share each staged cache tile, so the cache is read once per kv
// head: that is the point of the GQA fold. `index` and `valid_from` are read
// from device memory (no host sync). Any L is served: the ragged last tile is
// masked by index, so the dense strip of length max_len + 1 (the batcher's
// trash slot) runs here, where the TPU path refused it. Tiles wholly past
// `index` or wholly inside the left padding are skipped, as there.
//
// Bound. One step reads the live cache once (2 * live * hd * bytes per kv
// head) and does ~4 * g * live * hd operations: bytes bound at every g the
// models use. This first version stages each 64-key tile through shared
// memory as f32 with plain loads and one block per kv head; the split
// variant is what spreads a long cache over more SMs. cp.async/TMA double
// buffering is later work (PERF.md has its numbers).
#include "common.cuh"

namespace {

using adapt::from_f;
using adapt::kNegInf;
using adapt::to_f;

constexpr int TK = 64;     // keys per tile
constexpr int NT = 128;    // threads per block (4 warps)
constexpr int MAX_G = 16;  // folded query rows per kv head

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ index,
                  const int* __restrict__ valid_from, T* __restrict__ out,
                  float* __restrict__ o_part, float* __restrict__ m_part,
                  float* __restrict__ l_part, int kvh, int g, int L,
                  int tiles_per_split, float sm_scale) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 1;
  constexpr int NACC = MAX_G * HD / NT;
  float* qs = smem;              // g * HD
  float* ks = qs + MAX_G * HD;   // TK * LD
  float* vs = ks + TK * LD;      // TK * LD
  float* ss = vs + TK * LD;      // g * TK
  float* m_s = ss + MAX_G * TK;  // g
  float* l_s = m_s + MAX_G;
  float* a_s = l_s + MAX_G;

  const int row = blockIdx.x;  // b * kvh + kv head
  const int sp = blockIdx.y;
  const int nsplit = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int bi = row / kvh;
  const int idx = index[bi];
  const int vfrom = valid_from ? valid_from[bi] : 0;
  const size_t cbase = (size_t)row * L * HD;
  const int nq = g * HD;

  for (int i = tid; i < nq; i += NT)
    qs[i] = to_f(q[(size_t)row * nq + i]);
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  __syncthreads();

  const int num_tiles = (L + TK - 1) / TK;
  const int t_lo = sp * tiles_per_split;
  const int t_hi = min(num_tiles, t_lo + tiles_per_split);
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * TK;
    // Dead tiles: wholly past the write index, or inside the left padding.
    if (k0 > idx || k0 + TK <= vfrom) continue;

    __syncthreads();  // previous tile's readers are done
    for (int i = tid; i < TK * HD; i += NT) {
      const int r = i / HD, c = i % HD;
      const int gk = k0 + r;
      const bool in = gk < L;
      ks[r * LD + c] = in ? to_f(k[cbase + (size_t)gk * HD + c]) : 0.f;
      vs[r * LD + c] = in ? to_f(v[cbase + (size_t)gk * HD + c]) : 0.f;
    }
    __syncthreads();

    for (int p = tid; p < g * TK; p += NT) {
      const int r = p / TK, c = p % TK;
      const int col = k0 + c;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += qs[r * HD + d] * ks[c * LD + d];
      const bool live = col <= idx && col >= vfrom && col < L;
      ss[p] = live ? dot * sm_scale : kNegInf;
    }
    __syncthreads();

    // Online softmax: one warp per folded row, two keys per lane.
    for (int r = warp; r < g; r += NT / 32) {
      float* srow = ss + r * TK;
      const float x0 = srow[lane], x1 = srow[lane + 32];
      float tmax = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tmax);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      srow[lane] = p0;
      srow[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int o = tid + i * NT;
      if (o < nq) {
        const int r = o / HD, d = o % HD;
        float a = acc[i] * a_s[r];
        const float* prow = ss + r * TK;
#pragma unroll 8
        for (int c = 0; c < TK; ++c) a += prow[c] * vs[c * LD + d];
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  if (o_part != nullptr) {
    const size_t pbase = (size_t)row * nsplit + sp;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int o = tid + i * NT;
      if (o < nq) o_part[pbase * nq + o] = acc[i];
    }
    if (tid < g) {
      m_part[pbase * g + tid] = m_s[tid];
      l_part[pbase * g + tid] = l_s[tid];
    }
  } else {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int o = tid + i * NT;
      if (o < nq)
        out[(size_t)row * nq + o] =
            from_f<T>(acc[i] / fmaxf(l_s[o / HD], 1e-30f));
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* index,
           const int* valid_from, void* out, float* o_part, float* m_part,
           float* l_part, int b, int kvh, int g, int L, int split,
           float sm_scale, cudaStream_t stream) {
  const int bytes =
      (MAX_G * HD + 2 * TK * (HD + 1) + MAX_G * TK + 3 * MAX_G) *
      (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int num_tiles = (L + TK - 1) / TK;
  const int tps = (num_tiles + split - 1) / split;
  dim3 grid(b * kvh, split);
  decode_kernel<T, HD><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), index, valid_from, static_cast<T*>(out),
      o_part, m_part, l_part, kvh, g, L, tps, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int by_dim(int hd, const void* q, const void* k, const void* v,
           const int* index, const int* vf, void* out, float* o_part,
           float* m_part, float* l_part, int b, int kvh, int g, int L,
           int split, float sm_scale, cudaStream_t stream) {
  if (g < 1 || g > MAX_G || split < 1) return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return launch<T, 64>(q, k, v, index, vf, out, o_part, m_part, l_part, b,
                         kvh, g, L, split, sm_scale, stream);
  if (hd == 128)
    return launch<T, 128>(q, k, v, index, vf, out, o_part, m_part, l_part, b,
                          kvh, g, L, split, sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// split == 1 with o_part == nullptr writes the normalised output (K2);
// otherwise each (row, split) block writes its partials (K2-split).
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           const int* index, const int* valid_from, void* out,
                           float* o_part, float* m_part, float* l_part, int b,
                           int kvh, int g, int L, int hd, int split, int dtype,
                           float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case adapt::kF32:
      return by_dim<float>(hd, q, k, v, index, valid_from, out, o_part,
                           m_part, l_part, b, kvh, g, L, split, sm_scale, st);
    case adapt::kBF16:
      return by_dim<__nv_bfloat16>(hd, q, k, v, index, valid_from, out,
                                   o_part, m_part, l_part, b, kvh, g, L, split,
                                   sm_scale, st);
    case adapt::kF16:
      return by_dim<__half>(hd, q, k, v, index, valid_from, out, o_part,
                            m_part, l_part, b, kvh, g, L, split, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
