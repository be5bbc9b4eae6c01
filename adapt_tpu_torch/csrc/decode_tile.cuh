// The decode-attention body shared by K2 (dense strips, decode_attn.cu) and
// K3 (paged pools, paged_attn.cu): one attention discipline, two layouts,
// three cache element types.
//
// The TPU package runs K3 as K2's kernel body behind a different block fetch
// (adapt_tpu/ops/paged_attention.py:_paged_kernel delegates to
// _decode_kernel), and every branch of it through one step body
// (adapt_tpu/ops/decode_attention.py:_attend_tile). Here the one body is a
// template over an ADDRESS functor that maps (row, key position) to the
// key's vector index in the K/V buffers, and over a CACHE-ELEMENT policy
// (common.cuh) that stages a vector's columns from that index: native
// values, int8 values with a per-vector f32 scale, or int4 values packed two
// per byte with the same scale, unpacked in registers. Everything else - the
// 64-key tile order, the dead-tile skip, the f32 online softmax, the split
// partials - is this one piece of code. So K2 and K3 do the same arithmetic
// in the same order, and a paged decode equals a dense decode bit for bit
// whenever the live positions hold the same K/V, quantized or not.
//
// Quantized caches (K2q / K3q). The scales factor out of the per-vector
// products, as in _attend_tile: score = (q . k_int) * k_scale * sm_scale,
// the reference's op order (ops/decode_attention.decode_attention_reference),
// and the PV product takes p * v_scale. The v-scale multiplies only the
// probabilities that feed the accumulator, never the denominator l.
//
// Bound. One step reads the live cache once (2 * live * (hd * value bytes +
// scale bytes) per kv head) and does ~4 * g * live * hd operations: bytes
// bound at every g the models use. This first version stages each 64-key
// tile through shared memory as f32 with plain loads, one block per (row,
// split); cp.async/TMA double buffering is later work (PERF.md has its
// numbers).
#pragma once

#include "common.cuh"

namespace adapt {
namespace decode {

constexpr int TK = 64;     // keys per tile
constexpr int NT = 128;    // threads per block (4 warps)
constexpr int MAX_G = 16;  // folded query rows per kv head

template <int HD>
constexpr int smem_bytes() {
  return (MAX_G * HD + 2 * TK * (HD + 1) + MAX_G * TK + 2 * TK + 3 * MAX_G) *
         (int)sizeof(float);
}

// Dense strips (b, kv_h, L, w): key p of row r is the strip row r * L + p.
struct DenseAddr {
  int L;
  __device__ __forceinline__ size_t operator()(int row, int p) const {
    return (size_t)row * L + p;
  }
};

// Paged pools (num_pages, kv_h, page, w) with a (b, pps) page table: key p
// of row (b, h) lives in physical page table[b, p / page] at offset
// p % page. The table is read from device memory, any page size.
struct PagedAddr {
  const int* table;
  int kvh, pps, page;
  __device__ __forceinline__ size_t operator()(int row, int p) const {
    const int bi = row / kvh, h = row % kvh;
    const int phys = table[bi * pps + p / page];
    return ((size_t)phys * kvh + h) * page + p % page;
  }
};

// One block per (b * kv_h row, split). `L` is the key range (strip length,
// or pps * page); `index` < 0 marks a dead row: every tile is skipped and
// the output is zeros (partials m = -1e30, l = 0).
template <typename T, int HD, typename KV, typename Addr>
__global__ void __launch_bounds__(NT)
    decode_kernel(const T* __restrict__ q, KV kv, const int* __restrict__ index,
                  const int* __restrict__ valid_from, T* __restrict__ out,
                  float* __restrict__ o_part, float* __restrict__ m_part,
                  float* __restrict__ l_part, int kvh, int g, int L,
                  int tiles_per_split, float sm_scale, Addr addr) {
  extern __shared__ float smem[];
  constexpr int LD = HD + 1;
  constexpr int NACC = MAX_G * HD / NT;
  constexpr int TPR = NT / TK;    // staging threads per key row
  constexpr int CPT = HD / TPR;   // columns each of them stages
  static_assert(NT % TK == 0 && HD % TPR == 0, "staging split");
  float* qs = smem;              // g * HD
  float* ks = qs + MAX_G * HD;   // TK * LD
  float* vs = ks + TK * LD;      // TK * LD
  float* ss = vs + TK * LD;      // g * TK
  float* ksc = ss + MAX_G * TK;  // TK key scales (quantized caches)
  float* vsc = ksc + TK;         // TK value scales
  float* m_s = vsc + TK;         // g
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
    {
      // NT / TK threads stage each key row, each CPT contiguous columns:
      // one vector index per thread per tile (on the paged layout one
      // table load and one division), computed in registers before any
      // load, so the loads of a thread go out back to back.
      const int r = tid / TPR, c0 = (tid % TPR) * CPT;
      const int gk = k0 + r;
      const bool in = gk < L;
      const size_t vec = in ? addr(row, gk) : 0;
      kv.template stage<CPT>(in, vec, c0, ks + r * LD + c0, vs + r * LD + c0);
      if (KV::kScaled && tid % TPR == 0) {
        ksc[r] = kv.k_scale(in, vec);
        vsc[r] = kv.v_scale(in, vec);
      }
    }
    __syncthreads();

    for (int p = tid; p < g * TK; p += NT) {
      const int r = p / TK, c = p % TK;
      const int col = k0 + c;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += qs[r * HD + d] * ks[c * LD + d];
      if (KV::kScaled) dot *= ksc[c];  // (q . k_int) * k_scale * sm_scale
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

    // acc = acc * alpha + p v; a quantized cache weights p by the value
    // scale here, after l summed the unscaled p.
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int o = tid + i * NT;
      if (o < nq) {
        const int r = o / HD, d = o % HD;
        float a = acc[i] * a_s[r];
        const float* prow = ss + r * TK;
        if (KV::kScaled) {
#pragma unroll 8
          for (int c = 0; c < TK; ++c)
            a += (prow[c] * vsc[c]) * vs[c * LD + d];
        } else {
#pragma unroll 8
          for (int c = 0; c < TK; ++c) a += prow[c] * vs[c * LD + d];
        }
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

// Launch over `rows` = b * kv_h rows and `split` key-range splits; `L` is
// the key range. split == 1 with o_part == nullptr writes the normalised
// output; otherwise each (row, split) block writes its partials.
template <typename T, int HD, typename KV, typename Addr>
int launch(const void* q, KV kv, const int* index, const int* valid_from,
           void* out, float* o_part, float* m_part, float* l_part, int rows,
           int kvh, int g, int L, int split, float sm_scale, Addr addr,
           cudaStream_t stream) {
  const int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, HD, KV, Addr>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int num_tiles = (L + TK - 1) / TK;
  const int tps = (num_tiles + split - 1) / split;
  dim3 grid(rows, split);
  decode_kernel<T, HD, KV, Addr><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), kv, index, valid_from, static_cast<T*>(out),
      o_part, m_part, l_part, kvh, g, L, tps, sm_scale, addr);
  return (int)cudaGetLastError();
}

// Head-dim and cache-element dispatch of one entry point (head dims 64 and
// 128; the KVCode of common.cuh).
template <typename T, int HD, typename Addr>
int by_kv(int kvc, const void* q, const void* k, const void* v,
          const float* ks, const float* vs, const int* index, const int* vf,
          void* out, float* o_part, float* m_part, float* l_part, int rows,
          int kvh, int g, int L, int split, float sm_scale, Addr addr,
          cudaStream_t st) {
  return with_kv<T, HD>(kvc, k, v, ks, vs, [&](auto kv) {
    return launch<T, HD>(q, kv, index, vf, out, o_part, m_part, l_part, rows,
                         kvh, g, L, split, sm_scale, addr, st);
  });
}

template <typename T, typename Addr>
int by_dim(int hd, int kvc, const void* q, const void* k, const void* v,
           const float* ks, const float* vs, const int* index, const int* vf,
           void* out, float* o_part, float* m_part, float* l_part, int rows,
           int kvh, int g, int L, int split, float sm_scale, Addr addr,
           cudaStream_t st) {
  if (hd == 64)
    return by_kv<T, 64>(kvc, q, k, v, ks, vs, index, vf, out, o_part, m_part,
                        l_part, rows, kvh, g, L, split, sm_scale, addr, st);
  if (hd == 128)
    return by_kv<T, 128>(kvc, q, k, v, ks, vs, index, vf, out, o_part,
                         m_part, l_part, rows, kvh, g, L, split, sm_scale,
                         addr, st);
  return (int)cudaErrorInvalidValue;
}

// `dtype` is the query's (and the output's) dtype code, `kvc` the cache's
// KVCode; k/v are the value buffers, ks/vs the scale planes (nullptr for a
// native cache).
template <typename Addr>
int dispatch(int dtype, int kvc, int hd, const void* q, const void* k,
             const void* v, const float* ks, const float* vs,
             const int* index, const int* vf, void* out, float* o_part,
             float* m_part, float* l_part, int rows, int kvh, int g, int L,
             int split, float sm_scale, Addr addr, cudaStream_t st) {
  if (g < 1 || g > MAX_G || split < 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return by_dim<float>(hd, kvc, q, k, v, ks, vs, index, vf, out, o_part,
                           m_part, l_part, rows, kvh, g, L, split, sm_scale,
                           addr, st);
    case kBF16:
      return by_dim<__nv_bfloat16>(hd, kvc, q, k, v, ks, vs, index, vf, out,
                                   o_part, m_part, l_part, rows, kvh, g, L,
                                   split, sm_scale, addr, st);
    case kF16:
      return by_dim<__half>(hd, kvc, q, k, v, ks, vs, index, vf, out, o_part,
                            m_part, l_part, rows, kvh, g, L, split, sm_scale,
                            addr, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace decode
}  // namespace adapt
