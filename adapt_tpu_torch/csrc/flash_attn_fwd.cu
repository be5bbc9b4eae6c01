// K1: forward flash attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel adapt_tpu/ops/attention.py:_attn_kernel (reached
// through _flash_impl): softmax(q k^T * sm_scale) v over (b, h, s, d)
// tensors with an f32 online softmax, the masks of that kernel (causal with
// a traced diagonal shift, a sliding window, a ragged key tail valid_k = s_k
// and a per-batch-row valid_from left-pad mask), skipping of dead key tiles,
// and a per-row logsumexp output.
//
// Design. One thread block per (b*h, 64-row query tile). A CUDA grid has no
// sequential axis to carry softmax state across, so the key loop runs inside
// the block: each 64-key K/V tile is staged in shared memory as f32, the
// block computes the 64x64 score tile into shared memory, four threads per
// row reduce it (max, exp, sum), and the (m, l) state lives in shared memory
// while the 64 x d accumulator lives in registers (each of the 256 threads
// owns a 4 x d/16 piece). Ragged s_q / s_k are masked by index, so nothing is
// zero-padded in device memory.
//
// Bound. At the prefill shapes of the main path (s <= 1024, d = 64) the
// work is 4*s^2*d/2 operations per (b, h) against 4*s*d bytes of q/k/v/out:
// operations bound on paper. This first version computes the two products
// on the CUDA cores in f32 from shared memory (no tensor cores): it is right
// first and slow; wgmma + TMA are later work (PERF.md has its numbers).
#include "common.cuh"

namespace {

using adapt::from_f;
using adapt::kNegInf;
using adapt::to_f;

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block (16 x 16)

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse,
                     const int* __restrict__ valid_from,
                     const int* __restrict__ shift_ptr, int h, int s_q,
                     int s_k, int causal, int window, float sm_scale) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;  // +1 pad: conflict-free column walks
  constexpr int LS = BK + 1;
  constexpr int DJ = D / 16;
  float* qs = smem;
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* ss = vs + BK * LD;
  float* m_s = ss + BQ * LS;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const size_t qbase = (size_t)bh * s_q * D;
  const size_t kbase = (size_t)bh * s_k * D;
  const int vfrom = valid_from ? valid_from[bh / h] : 0;
  const int shift = shift_ptr ? *shift_ptr : 0;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    const int gr = q0 + r;
    qs[r * LD + c] = gr < s_q ? to_f(q[qbase + (size_t)gr * D + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int num_kv = (s_k + BK - 1) / BK;
  for (int j = 0; j < num_kv; ++j) {
    const int k0 = j * BK;
    // Dead-tile skip, the same predicates as _attn_kernel (block-uniform).
    bool live = true;
    if (causal) {
      live = k0 + shift <= q0 + BQ - 1;
      if (window > 0) live = live && (k0 + BK - 1 > q0 - window);
    }
    if (valid_from) live = live && (k0 + BK > vfrom);
    if (!live) continue;

    __syncthreads();  // the previous tile's readers are done with ks/vs/ss
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const int gk = k0 + r;
      const bool in = gk < s_k;
      ks[r * LD + c] = in ? to_f(k[kbase + (size_t)gk * D + c]) : 0.f;
      vs[r * LD + c] = in ? to_f(v[kbase + (size_t)gk * D + c]) : 0.f;
    }
    __syncthreads();

    // Scores: thread (ty, tx) owns rows ty + 16 i and keys tx + 16 jj.
    float dot[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) dot[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = ks[(tx + 16 * jj) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) dot[i][jj] += qv[i] * kv[jj];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int c = tx + 16 * jj;
        const int col = k0 + c;
        float s = dot[i][jj] * sm_scale;
        if (col >= s_k) s = kNegInf;
        if (valid_from && col < vfrom) s = kNegInf;
        if (causal) {
          if (!(row >= col + shift)) s = kNegInf;
          if (window > 0 && !(col > row - window)) s = kNegInf;
        }
        ss[r * LS + c] = s;
      }
    }
    __syncthreads();

    // Online softmax: four neighbouring lanes per row, 16 keys each.
    {
      const int r = tid / 4;
      const int part = tid % 4;
      float* srow = ss + r * LS + part * 16;
      float tmax = srow[0];
#pragma unroll
      for (int c = 1; c < 16; ++c) tmax = fmaxf(tmax, srow[c]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, tmax);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ss[(ty + 16 * i) * LS + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) vv[jj] = vs[c * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] += pv[i] * vv[jj];
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row >= s_q) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      out[qbase + (size_t)row * D + tx + 16 * jj] = from_f<T>(acc[i][jj] / l);
  }
  if (lse != nullptr && tid < BQ && q0 + tid < s_q)
    lse[(size_t)bh * s_q + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           const int* valid_from, const int* shift, int b, int h, int s_q,
           int s_k, int causal, int window, float sm_scale,
           cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b * h, (s_q + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, valid_from, shift,
      h, s_q, s_k, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int by_dim(int d, const void* q, const void* k, const void* v, void* out,
           float* lse, const int* vf, const int* shift, int b, int h, int s_q,
           int s_k, int causal, int window, float sm_scale,
           cudaStream_t stream) {
  if (d == 64)
    return launch<T, 64>(q, k, v, out, lse, vf, shift, b, h, s_q, s_k, causal,
                         window, sm_scale, stream);
  if (d == 128)
    return launch<T, 128>(q, k, v, out, lse, vf, shift, b, h, s_q, s_k,
                          causal, window, sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* out, float* lse, const int* valid_from,
                              const int* shift, int b, int h, int s_q, int s_k,
                              int d, int dtype, int causal, int window,
                              float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case adapt::kF32:
      return by_dim<float>(d, q, k, v, out, lse, valid_from, shift, b, h, s_q,
                           s_k, causal, window, sm_scale, st);
    case adapt::kBF16:
      return by_dim<__nv_bfloat16>(d, q, k, v, out, lse, valid_from, shift, b,
                                   h, s_q, s_k, causal, window, sm_scale, st);
    case adapt::kF16:
      return by_dim<__half>(d, q, k, v, out, lse, valid_from, shift, b, h,
                            s_q, s_k, causal, window, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
